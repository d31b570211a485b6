"""JAX package variables -> the port's state_dict.

The port's state_dict keys are the reference checkpoint's, so this is the
inverse of the JAX package's torch -> JAX converter, with this package's
own copy of its rule table. Layouts undone:

  conv2d  HWIO                 -> OIHW
  conv3d  DHWIO                -> OIDHW
  deconv  flipped [*S, I, O]   -> [I, O, *S] (torch ConvTranspose layout)
  linear  [in, out]            -> [out, in]
  DCN     tap-major [K, I, O]  -> [O, I, kh, kw]
  BN      scale/bias + batch_stats mean/var -> weight/bias/running_*

Strict: every rule must find its leaf and every leaf must be consumed.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch


def _conv2d(w):
    return np.transpose(w, (3, 2, 0, 1))


def _conv3d(w):
    return np.transpose(w, (4, 3, 0, 1, 2))


def _deconv3d(w):
    return np.flip(np.transpose(w, (3, 4, 0, 1, 2)), axis=(2, 3, 4))


def _linear(w):
    return np.transpose(w)


def _dcn(w):
    k, i, o = w.shape
    kh = int(round(k**0.5))
    return np.transpose(w.reshape(kh, kh, i, o), (3, 2, 0, 1))


def _conv_block(src, dst, rules, bn=True, conv3d=False, deconv=False):
    if deconv:
        kfn = _deconv3d
    else:
        kfn = _conv3d if conv3d else _conv2d
    rules.append((f"{src}.conv.weight", dst + ("conv", "kernel"), kfn))
    if bn:
        _bare_bn(f"{src}.bn", dst + ("bn",), rules)
    else:
        rules.append((f"{src}.conv.bias", dst + ("conv", "bias"), None))


def _bare_bn(src, dst, rules):
    rules += [
        (f"{src}.weight", dst + ("scale",), None),
        (f"{src}.bias", dst + ("bias",), None),
        (f"{src}.running_mean", ("batch_stats",) + dst[1:] + ("mean",), None),
        (f"{src}.running_var", ("batch_stats",) + dst[1:] + ("var",), None),
    ]


def _dcn_block(src, dst, rules):
    rules += [
        (f"{src}.conv_offset_mask.weight", dst + ("conv_offset_mask", "kernel"), _conv2d),
        (f"{src}.conv_offset_mask.bias", dst + ("conv_offset_mask", "bias"), None),
        (f"{src}.weight", dst + ("weight",), _dcn),
        (f"{src}.bias", dst + ("bias",), None),
    ]


def build_rules(num_stages: int, fmt_layers: int) -> list:
    """(port key, JAX leaf path, JAX -> torch layout fn or None)."""
    rules: list = []
    P = ("params",)
    for blk, count in [("conv0", 2), ("conv1", 3), ("conv2", 3)]:
        for i in range(count):
            _conv_block(f"feature.{blk}.{i}", P + ("feature", f"{blk}_{i}"), rules)
    for head in ("out1", "out2", "out3"):
        _conv_block(f"feature.{head}.0", P + ("feature", head, "lead"), rules)
        _dcn_block(f"feature.{head}.1", P + ("feature", head, "dcn0"), rules)
        _bare_bn(f"feature.{head}.2", P + ("feature", head, "bn0"), rules)
        _dcn_block(f"feature.{head}.4", P + ("feature", head, "dcn1"), rules)
        _bare_bn(f"feature.{head}.5", P + ("feature", head, "bn1"), rules)
        _dcn_block(f"feature.{head}.7", P + ("feature", head, "dcn2"), rules)
    for inner in ("inner1", "inner2"):
        rules += [
            (f"feature.{inner}.weight", P + ("feature", inner, "kernel"), _conv2d),
            (f"feature.{inner}.bias", P + ("feature", inner, "bias"), None),
        ]
    for i in range(fmt_layers):
        base = f"FMT_with_pathway.FMT.layers.{i}"
        dst = P + ("fmt", "FMT", f"layer{i}")
        for proj, name in [
            ("query_projection", "query"),
            ("key_projection", "key"),
            ("value_projection", "value"),
            ("out_projection", "out"),
        ]:
            rules += [
                (f"{base}.attention.{proj}.weight", dst + ("attention", name, "kernel"), _linear),
                (f"{base}.attention.{proj}.bias", dst + ("attention", name, "bias"), None),
            ]
        for lin in ("linear1", "linear2"):
            rules += [
                (f"{base}.{lin}.weight", dst + (lin, "kernel"), _linear),
                (f"{base}.{lin}.bias", dst + (lin, "bias"), None),
            ]
        for norm in ("norm1", "norm2"):
            rules += [
                (f"{base}.{norm}.weight", dst + (norm, "scale"), None),
                (f"{base}.{norm}.bias", dst + (norm, "bias"), None),
            ]
    for name in ("dim_reduction_1", "dim_reduction_2", "smooth_1", "smooth_2"):
        rules.append((f"FMT_with_pathway.{name}.weight", P + ("fmt", name, "kernel"), _conv2d))
    for s in range(num_stages):
        base = f"cost_regularization.{s}"
        dst = P + (f"cost_regs_{s}",)
        for conv in ("conv0", "conv1", "conv2", "conv3", "conv4", "conv5", "conv6"):
            _conv_block(f"{base}.{conv}", dst + (conv,), rules, conv3d=True)
        for conv in ("conv7", "conv9", "conv11"):
            _conv_block(f"{base}.{conv}", dst + (conv,), rules, conv3d=True, deconv=True)
        rules.append((f"{base}.prob.weight", dst + ("prob", "kernel"), _conv3d))
    for conv in ("conv0", "conv1"):
        _conv_block(f"DepthNet.pixel_wise_net.{conv}", P + ("pixel_wise_net", conv), rules,
                    conv3d=True)
    rules += [
        ("DepthNet.pixel_wise_net.conv2.weight", P + ("pixel_wise_net", "conv2", "kernel"), _conv3d),
        ("DepthNet.pixel_wise_net.conv2.bias", P + ("pixel_wise_net", "conv2", "bias"), None),
    ]
    return rules


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (str(k),)))
        else:
            flat[prefix + (str(k),)] = np.asarray(v)
    return flat


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """{"params", "batch_stats"} nested dicts of arrays -> port state_dict
    (float32 tensors; ``num_batches_tracked`` set to 0). The number of
    cascade stages and FMT layers is read from the tree."""
    flat = _flatten(variables)
    params = variables["params"]
    num_stages = sum(1 for k in params if str(k).startswith("cost_regs_"))
    fmt_layers = sum(1 for k in params["fmt"]["FMT"] if str(k).startswith("layer"))
    sd: dict[str, torch.Tensor] = {}
    consumed = set()
    for key, path, fn in build_rules(num_stages, fmt_layers):
        if path not in flat:
            raise KeyError(f"JAX variables lack leaf {'/'.join(path)} for {key}")
        val = flat[path]
        val = fn(val) if fn else val
        sd[key] = torch.from_numpy(np.ascontiguousarray(val, dtype=np.float32))
        consumed.add(path)
        if key.endswith(".running_mean"):
            sd[key.removesuffix("running_mean") + "num_batches_tracked"] = torch.tensor(0)
    leftover = set(flat) - consumed
    if leftover:
        raise KeyError(f"unconsumed JAX leaves: {sorted('/'.join(p) for p in leftover)[:10]}")
    return sd
