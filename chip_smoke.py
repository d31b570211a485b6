"""GPU smoke run of the PyTorch/CUDA port at the DTU eval setting.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this repository's
``transmvsnet_tpu_torch`` package. Phases, in order; any failure raises:

1. Device: the card's name and power limit (nvidia-smi).
2. Build: compile every kernel under ``transmvsnet_tpu_torch/csrc``.
3. Kernel checks: each kernel against its plain PyTorch version on the
   card, on the same bfloat16 inputs, at every shape the main path gives
   it; kernel and plain times by CUDA events.
4. Main path: the cascade at 1152x864, 5 views, batch 1, 48/32/8
   hypotheses, bfloat16, random weights from a seeded generator; a few
   requests with the launch counts read around them; the same model and
   inputs with the plain ops for agreement; depth-maps/s, peak memory and
   one forward's time by part of the model.
5. Last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, same source
H, W, V, B = 864, 1152, 5, 1
NDEPTHS = (48, 32, 8)
NUM_HYP = 192
REQUESTS = 3


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth and
    operations over the bf16 tensor-core peak, the larger of the two."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / BF16_FLOPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol_scale: float) -> dict:
    """|got - want| <= rtol*|want| + atol_scale*max|want| at every element."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = want.abs().max().item()
    tol = rtol * want.abs() + atol_scale * scale
    bad = int((err > tol).sum().item())
    return {
        "max_abs_err": err.max().item(),
        "median_abs_err": err.median().item(),
        "scale": scale,
        "tolerance": f"|d| <= {rtol:g}*|plain| + {atol_scale:g}*max|plain|",
        "n_outside": bad,
    }


def dcn_checks(dev, gen) -> dict:
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused, dcn_fused_plain

    # (h, w, C_out, launches per forward): the ARF heads' DCN layers.
    shapes = [
        (H // 4, W // 4, 32, 3),
        (H // 2, W // 2, 32, 2),
        (H // 2, W // 2, 16, 1),
        (H, W, 32, 2),
        (H, W, 8, 1),
    ]
    C, N = 32, B * V
    rows = []
    for h, w, c_out, per_fwd in shapes:
        def rnd(*shape, s=1.0):
            return (torch.randn(*shape, generator=gen) * s).to(dev)

        x = rnd(N, C, h, w).to(torch.bfloat16)
        # Offset-conv weights put offsets at a few pixels: non-integer, and
        # some taps off the image at every border.
        k_off = rnd(27, C, 3, 3, s=0.12)
        b_off = rnd(27, s=0.5)
        weight = rnd(9, C, c_out, s=0.1)
        bias = rnd(c_out, s=0.1)
        got = dcn_fused(x, k_off, b_off, weight, bias)
        want = dcn_fused_plain(x, k_off, b_off, weight, bias)
        torch.cuda.synchronize()
        # Both round one float32 result to bfloat16: at most one bf16 step
        # (2^-7 relative) apart, plus float32 summation-order noise.
        res = check_close(got, want, rtol=2.0**-7, atol_scale=1e-3)
        if res["n_outside"]:
            raise AssertionError(f"dcn_fused disagrees at {(N, C, h, w, c_out)}: {res}")
        ms = cuda_ms(lambda: dcn_fused(x, k_off, b_off, weight, bias), iters=10)
        plain_ms = cuda_ms(lambda: dcn_fused_plain(x, k_off, b_off, weight, bias), iters=2, warmup=1)
        pix = N * h * w
        nbytes = 2 * pix * C + 2 * pix * c_out + 4 * (27 * C * 9 + 27 + 9 * C * c_out + c_out)
        flops = 2 * pix * 9 * C * (27 + c_out + 4)
        bd = bound(nbytes, flops)
        rows.append(dict(shape=[N, C, h, w, c_out], per_forward=per_fwd, ms=ms,
                         plain_ms=plain_ms, **bd, **res))
        print(f"dcn_fused {[N, C, h, w, c_out]}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bd['bound_ms']:.4f} ({bd['bound_by']}) "
              f"max_abs_err {res['max_abs_err']:.3g}", flush=True)
    return summarise("dcn_fused", "transmvsnet_tpu_torch/csrc/dcn_fused.cu",
                     "transmvsnet_tpu/ops/pallas/dcn_onehot.py:610", rows)


def warp_checks(dev, gen) -> dict:
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
        warp_correlate,
        warp_correlate_plain,
    )
    from transmvsnet_tpu_torch.data.example import DEPTH_MAX, DEPTH_MIN, example_inputs
    from transmvsnet_tpu_torch.ops.geometry import fuse_projection

    _, projs, _ = example_inputs(B=B, V=V, H=H, W=W)
    S = V - 1
    rows = []
    for i, (stage, C, D) in enumerate([("stage1", 32, 48), ("stage2", 16, 32), ("stage3", 8, 8)]):
        scale = 2 ** (2 - i)
        h, w = H // scale, W // scale
        src = torch.randn(B, S, C, h, w, generator=gen).to(dev, torch.bfloat16)
        ref = torch.randn(B, C, h, w, generator=gen).to(dev, torch.bfloat16)
        base = torch.linspace(DEPTH_MIN, DEPTH_MAX, D)[None, :, None, None]
        depth = base + 5.0 * torch.rand(B, D, h, w, generator=gen)
        # A band behind the cameras: source z < 1e-6, sampled as zero.
        depth[:, :, : h // 16] *= -1.0
        depth = depth.to(dev).contiguous()
        fused = fuse_projection(torch.from_numpy(projs[stage]).to(dev))
        sp, rp = fused[:, 1:].contiguous(), fused[:, 0].contiguous()
        got = warp_correlate(src, ref, sp, rp, depth)
        want = warp_correlate_plain(src, ref, sp, rp, depth)
        torch.cuda.synchronize()
        # Same float32 arithmetic up to summation order and fused
        # multiply-adds in the projection (~1e-5 px of sample position).
        res = check_close(got, want, rtol=1e-3, atol_scale=1e-3)
        if res["n_outside"]:
            raise AssertionError(f"warp_correlate disagrees at {stage}: {res}")
        ms = cuda_ms(lambda: warp_correlate(src, ref, sp, rp, depth), iters=50, warmup=5)
        plain_ms = cuda_ms(lambda: warp_correlate_plain(src, ref, sp, rp, depth), iters=2, warmup=1)
        n_out = B * S * D * h * w
        valid = (want != 0).float().mean().item()
        nbytes = 2 * (B * S + B) * C * h * w + 4 * B * D * h * w + 4 * n_out + 4 * B * S * 12
        # Projection (~12) per output; bilinear sample and product (~10 C)
        # only where the sample is valid, as this run's data needs.
        flops = n_out * (12 + valid * 10 * C)
        bd = bound(nbytes, flops)
        rows.append(dict(shape=[B * S, C, D, h, w], per_forward=1, ms=ms, plain_ms=plain_ms,
                         nonzero_share=valid, **bd, **res))
        print(f"warp_correlate {[B * S, C, D, h, w]}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bd['bound_ms']:.4f} ({bd['bound_by']}) "
              f"max_abs_err {res['max_abs_err']:.3g} nonzero {valid:.3f}", flush=True)
    return summarise("warp_correlate", "transmvsnet_tpu_torch/csrc/warp_correlate.cu",
                     "transmvsnet_tpu/ops/pallas/warp_onehot.py:291", rows)


def summarise(name, source, replaces, rows) -> dict:
    """One kernel's entry: times and bound per forward of the main path
    (each shape's figure times its launches per forward), worst error."""
    def per_fwd(key):
        return sum(r[key] * r["per_forward"] for r in rows)

    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_fwd("ms"), "plain_ms": per_fwd("plain_ms"), "bound_ms": per_fwd("bound_ms"),
        "bound_by": "bytes" if per_fwd("bytes_ms") >= per_fwd("ops_ms") else "operations",
        "library_ms": None, "shapes": rows,
    }


def module_breakdown(model, forward) -> dict:
    """Milliseconds of one forward in each part of the model, by CUDA
    events recorded in forward hooks. "rest" is what no hooked module
    covers: the warp-correlation kernel, the view-weighted sum, softmax,
    WTA and the hypothesis geometry."""
    parts = [("fpn", m) for m in (model.feature.conv0, model.feature.conv1, model.feature.conv2,
                                  model.feature.inner1, model.feature.inner2)]
    parts += [(f"arf_head_stage{i + 1}", getattr(model.feature, f"out{i + 1}")) for i in range(3)]
    parts += [("fmt", model.FMT_with_pathway), ("pixelwise_net", model.DepthNet.pixel_wise_net)]
    parts += [(f"cost_reg_stage{i + 1}", m) for i, m in enumerate(model.cost_regularization)]
    spans, stack = [], []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def pre(label):
        return lambda mod, args: stack.append((label, event()))

    def post(mod, args, out):
        label, start = stack.pop()
        spans.append((label, start, event()))

    handles = [h for label, m in parts
               for h in (m.register_forward_pre_hook(pre(label)), m.register_forward_hook(post))]
    try:
        start = event()
        forward()
        end = event()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    out: dict[str, float] = {}
    for label, s, e in spans:
        out[label] = out.get(label, 0.0) + s.elapsed_time(e)
    total = start.elapsed_time(end)
    out["rest"] = total - sum(out.values())
    out["total"] = total
    return out


def main_path(dev) -> dict:
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.example import DEPTH_MAX, DEPTH_MIN, example_inputs
    from transmvsnet_tpu_torch.models.feature_net import DCN
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate

    gen = torch.Generator().manual_seed(0)
    cfg = ModelConfig(ndepths=NDEPTHS, compute_dtype="bfloat16")
    model = TransMVSNet(cfg, device=dev, generator=gen).eval()
    # The reference zero-initialises the offset convs; random weights and
    # biases (offsets of about a pixel, non-integer) exercise the
    # deformable path instead.
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCN):
                w, b = m.conv_offset_mask.weight, m.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=gen) * 0.05)
                b.copy_(torch.randn(b.shape, generator=gen) * 1.5)
    imgs, projs, dv = example_inputs(B=B, V=V, H=H, W=W, num_hyp=NUM_HYP)
    t_imgs = torch.from_numpy(imgs).to(dev)
    t_projs = {k: torch.from_numpy(v).to(dev) for k, v in projs.items()}
    t_dv = torch.from_numpy(dv).to(dev)

    def forward():
        with torch.no_grad():
            return model(t_imgs, t_projs, t_dv)

    forward()  # warm-up: cuDNN plans and the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dcn_fused.launches = 0
    warp_correlate.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REQUESTS):
        out = forward()
    end.record()
    torch.cuda.synchronize()
    launches = {"dcn_fused": dcn_fused.launches, "warp_correlate": warp_correlate.launches}
    ms_per_map = start.elapsed_time(end) / REQUESTS
    peak = torch.cuda.max_memory_allocated()
    print(f"main path: {REQUESTS} requests, launches {launches}", flush=True)
    if launches != {"dcn_fused": 9 * REQUESTS, "warp_correlate": 3 * REQUESTS}:
        raise AssertionError(f"expected 9 dcn_fused and 3 warp_correlate launches per forward: {launches}")

    for s in ("stage1", "stage2", "stage3"):
        d, dvals = out[s]["depth"], out[s]["depth_values"]
        conf = out[s]["photo_confidence"]
        if not torch.isfinite(d).all() or not torch.isfinite(out[s]["prob_volume"]).all():
            raise AssertionError(f"{s}: non-finite output")
        lo, hi = dvals.amin(dim=1), dvals.amax(dim=1)
        if not ((d >= lo) & (d <= hi)).all():
            raise AssertionError(f"{s}: depth outside its hypothesis range")
        if not ((conf >= 0) & (conf <= 1)).all():
            raise AssertionError(f"{s}: confidence outside [0, 1]")
    if tuple(out["depth"].shape) != (B, H, W):
        raise AssertionError(f"depth shape {tuple(out['depth'].shape)}")

    breakdown = module_breakdown(model, forward)

    model.use_plain_ops(True)
    forward()
    plain_ms = cuda_ms(forward, iters=1, warmup=0)
    plain = forward()
    model.use_plain_ops(False)
    interval = cfg.depth_interval_ratios[2] * (DEPTH_MAX - DEPTH_MIN) / NUM_HYP
    agree = ((out["depth"] - plain["depth"]).abs() <= interval).float().mean().item()
    dprob = {
        s: (out[s]["prob_volume"] - plain[s]["prob_volume"]).abs().max().item()
        for s in ("stage1", "stage2", "stage3")
    }
    result = {
        "depth_maps_per_s": 1e3 / ms_per_map,
        "ms_per_depth_map": ms_per_map,
        "plain_ops_ms_per_depth_map": plain_ms,
        "peak_memory_bytes": peak,
        "launches": launches,
        "ms_by_part": breakdown,
        "stage3_depth_within_one_interval_of_plain": agree,
        "max_abs_dprob_vs_plain": dprob,
    }
    print("main path: " + json.dumps(result), flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    # Float32 comparisons on the card in full float32, not TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from transmvsnet_tpu_torch.ops.cuda import build

    seconds = build.build_all()
    print(f"build: {seconds:.1f} s", flush=True)
    for name, log in sorted(build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(1)
    kernels = [dcn_checks(dev, gen), warp_checks(dev, gen)]
    result = main_path(dev)
    for k in kernels:
        k["launches"] = result["launches"][k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
