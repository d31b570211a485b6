"""Profile the inference forward on the card with torch.profiler.

    python -m transmvsnet_tpu_torch.tools.profile [--logdir ./traces]
        [--height 864 --width 1152 --nviews 5 --ndepths 48,32,8]

Warm-up forwards, then ``--iters`` forwards traced with CPU and CUDA
activity. Prints one JSON line: wall milliseconds per forward (CUDA
events), device-busy milliseconds per forward (the union of the traced
kernels' intervals), the device's idle share, the kernels that take the
most device time, the port's own kernels' totals, and every launch of
1 ms or more in the first traced forward, in order. With ``--logdir`` it
also writes a Chrome trace.
Weights are random from a seeded generator; bf16 activations.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Profile the inference forward (PyTorch/CUDA)")
    p.add_argument("--logdir", default="", help="write a Chrome trace here")
    p.add_argument("--height", type=int, default=864)
    p.add_argument("--width", type=int, default=1152)
    p.add_argument("--nviews", type=int, default=5)
    p.add_argument("--ndepths", default="48,32,8")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--top", type=int, default=15)
    return p.parse_args(argv)


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA card; torch.cuda.is_available() is false")
    from torch.profiler import ProfilerActivity, profile

    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.example import example_inputs
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet

    dev = torch.device("cuda", 0)
    cfg = ModelConfig(ndepths=tuple(int(x) for x in args.ndepths.split(",")),
                      compute_dtype="bfloat16")
    model = TransMVSNet(cfg, device=dev, generator=torch.Generator().manual_seed(0)).eval()
    imgs, projs, dv = example_inputs(V=args.nviews, H=args.height, W=args.width)
    inputs = (
        torch.from_numpy(imgs).to(dev),
        {k: torch.from_numpy(v).to(dev) for k, v in projs.items()},
        torch.from_numpy(dv).to(dev),
    )

    def forward():
        with torch.no_grad():
            model(*inputs)

    for _ in range(args.warmup):
        forward()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.iters):
            forward()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / args.iters

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the trace holds no device activity; time with CUDA events instead")
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    device_ms = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / args.iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
    first = sorted(kernels, key=lambda e: e.time_range.start)[: len(kernels) // args.iters]
    result = {
        "device": torch.cuda.get_device_name(0),
        "shape": [1, args.nviews, args.height, args.width],
        "ndepths": list(cfg.ndepths),
        "wall_ms_per_forward": wall_ms,
        "device_busy_ms_per_forward": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms,
        "kernel_launches_per_forward": len(kernels) / args.iters,
        "top_kernels": [
            {"name": name[:120], "ms_per_forward": us / 1e3 / args.iters,
             "launches_per_forward": n / args.iters}
            for name, (us, n) in top
        ],
        "port_kernels": {
            k: {"ms_per_forward": sum(v[0] for n, v in by_name.items() if k in n) / 1e3 / args.iters,
                "launches_per_forward": sum(v[1] for n, v in by_name.items() if k in n) / args.iters}
            for k in ("dcn_fused_kernel", "warp_correlate_kernel")
        },
        # Launches of 1 ms or more in the first traced forward, in order.
        "long_launches": [
            [e.name[:80], e.time_range.elapsed_us() / 1e3] for e in first
            if e.time_range.elapsed_us() >= 1e3
        ],
    }
    print(json.dumps(result))
    if args.logdir:
        os.makedirs(args.logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.logdir, "forward_trace.json"))


if __name__ == "__main__":
    main()
