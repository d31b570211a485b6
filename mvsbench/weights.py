"""Seeded random weights in the reference checkpoint's layout, made on the
device in two large draws.

Convolutions and linears take torch's default fan-in bounds (the FMT's
linears Xavier's), BatchNorm starts at its identity, every DCN layer's
offset/mask conv is drawn so that offsets are about a pixel and not
integers (a trained model's are not zero, and zero offsets flatter the
deformable kernels; their biases take one set of magnitudes for every
seed, shuffled, since the kernels' time depends on them), and each cost
regulariser's last conv is scaled by
the configuration's ``prob_gain`` so that the probability volumes are as
peaked as a trained model's. ``calibrated`` then sets BatchNorm's running
statistics from one forward of the plain reference on a calibration
scene, as a trained model's are set by its data, so that inference in
eval mode sees activations of the scale it would in use.
"""

from __future__ import annotations

import hashlib
import math

import torch
from torch import nn

from mvsbench.reference import model as ref


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag`` drawn from the run's ``--seed``."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def _rule(name: str, module: nn.Module, param: str) -> tuple[str, float]:
    """(distribution, scale) of one tensor: "u" uniform in +-scale, "n"
    normal with std scale, "q" the normal's quantiles (the same set of
    values for every seed, in an order drawn from it), "c" the constant
    scale."""
    if isinstance(module, ref.BatchNorm):
        return "c", {"weight": 1.0, "bias": 0.0, "running_mean": 0.0, "running_var": 1.0,
                     "num_batches_tracked": 0.0}[param]
    if isinstance(module, nn.LayerNorm):
        return "c", 1.0 if param == "weight" else 0.0
    if name.endswith("conv_offset_mask"):
        # The biases set how far each tap reaches, and so the deformable
        # kernels' time: the same magnitudes for every seed.
        return ("n", 0.05) if param == "weight" else ("q", 1.5)
    if isinstance(module, ref.DCN):
        return "u", 1.0 / math.sqrt(9 * module.weight.shape[1])
    w = module.weight
    if isinstance(module, nn.Linear) and param == "weight":
        return "u", math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    return "u", 1.0 / math.sqrt(fan_in)


def seeded_state_dict(layout: nn.Module, seed: int, device, prob_gain: float = 1.0) -> dict:
    """Every tensor of ``layout``'s state dict, drawn from ``seed`` on
    ``device``."""
    modules = dict(layout.named_modules())
    plan = []
    for key, t in layout.state_dict().items():
        name, _, param = key.rpartition(".")
        kind, scale = _rule(name, modules[name], param)
        if name.startswith("cost_regularization.") and name.endswith(".prob"):
            scale *= prob_gain
        plan.append((key, t, kind, scale))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    n_u = sum(t.numel() for _, t, k, _ in plan if k == "u")
    n_n = sum(t.numel() for _, t, k, _ in plan if k == "n")
    uniform = torch.rand(n_u, generator=gen, device=device) * 2 - 1
    normal = torch.randn(n_n, generator=gen, device=device)
    out, at = {}, {"u": 0, "n": 0}
    for key, t, kind, scale in plan:
        if kind == "c":
            out[key] = torch.full(t.shape, scale, dtype=t.dtype, device=device)
            continue
        if kind == "q":
            # Offsets (dy, dx) and mask logits each take the normal's
            # quantiles at (i + 1/2) / n, shuffled.
            parts = []
            for n in (t.numel() * 2 // 3, t.numel() // 3):
                q = torch.special.ndtri((torch.arange(n, device=device) + 0.5) / n) * scale
                parts.append(q[torch.randperm(n, generator=gen, device=device)])
            out[key] = torch.cat(parts)
            continue
        src = uniform if kind == "u" else normal
        out[key] = src[at[kind]:at[kind] + t.numel()].reshape(t.shape) * scale
        at[kind] += t.numel()
    return out


def reference_model(cfg: dict, device) -> ref.TransMVSNet:
    m = cfg["model"]
    return ref.TransMVSNet(m["ndepths"], m["depth_interval_ratios"], m["base_channels"], m["fmt_d_model"],
                           m["fmt_nhead"], m["fmt_layers"], m["cr_base_channels"]).to(device)


def calibrated(model: ref.TransMVSNet, state: dict, inputs) -> dict:
    """``state`` with BatchNorm's running statistics from one reference
    forward on ``inputs`` (imgs, projs, depth_values on the device)."""
    model.load_state_dict(state)
    with ref.full_float32():
        ref.calibrate_batchnorm(model, *inputs)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
