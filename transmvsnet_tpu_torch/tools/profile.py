"""Profile the inference forward, or a training step, on the card with
torch.profiler.

    python -m transmvsnet_tpu_torch.tools.profile [--train] [--logdir ./traces]
        [--nviews 5 --ndepths 48,32,8] [--dtype float32|bfloat16] [--fused]
        [--height H --width W --batch_size B] [--remat] [--dense_cost_reg 0|1]
        [--split_cost_reg]

Warm-up passes, then ``--iters`` passes traced with CPU and CUDA activity;
a pass is one forward, by default at the DTU eval setting (batch 1,
1152x864), or, with ``--train``, one ``train/step.py`` step with Adam, by
default at the DTU recipe (batch 2, 512x640); ``--height``, ``--width``
and ``--batch_size`` set other shapes (``tools/train.py --mode profile``
passes its run's batch). Prints one JSON line: wall milliseconds per pass
(CUDA events), device-busy milliseconds per pass (the union of the traced
kernels' intervals), the device's idle share, the kernels that take the
most device time, the port's own kernels' totals (``PORT_KERNELS``: each
kernel with every launch that belongs to it, such as K2/K6's and K7's
channels-last copy and K4's and K8's copy and planar write), and every
launch of 1 ms or more in the first traced pass, in order. With
``--logdir`` it also writes a Chrome trace. Weights are random from a seeded generator; activations in
``--dtype`` (float32 by default, as the CLIs); ``--fused`` sets
``fused_view_sum`` (bf16 stages 2-3 through K7 and K8), ``--remat``
``ModelConfig.remat`` (a train step recomputes the activations in its
backward), ``--dense_cost_reg`` the cost regulariser's form (by default
the config's). ``--split_cost_reg`` adds, per stage, the device time of
the cost regulariser's forward by part (``split_cost_reg``); it
synchronises the card around every part, so the pass's wall time is not
comparable with a run without it.

The JAX CLI's options, with six defaults changed on purpose (the recorded
profiles in PERF.md name command lines whose shapes follow them;
``tests/test_torch_cli_flags.py`` holds the list):

- ``--logdir ""`` (JAX ``./traces``): no trace unless asked for; a
  training trace is ~68 MB.
- ``--height 0``, ``--width 0`` (JAX 512, 640): 512x640 with ``--train``
  (the DTU recipe) and 864x1152 without (the DTU eval setting, where the
  JAX CLI profiles inference at the training shape).
- ``--batch_size 0`` (JAX 1): 2 with ``--train`` (the DTU recipe), 1
  without.
- ``--warmup 2``, ``--iters 3`` (JAX 3, 5): the card needs no compile
  warm-up, and three traced passes keep a training trace small.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
from collections import defaultdict

import torch

# The port's kernels in a trace: name -> the substring of the launch names
# (demangled CUDA function names) that belong to it.
PORT_KERNELS = {
    "dcn_fwd_kernel": "dcn_fwd_kernel",  # K1 in bf16 (last template argument true), K5
    "warp_correlate_kernel": "warp_correlate_fwd_",  # K2, K6: copy and body
    "warp_correlate_wsum_kernel": "warp_correlate_wsum_fwd_",  # K7: copy and body
    "dcn_bwd_kernel": "dcn_bwd_kernel",  # K3
    "warp_correlate_bwd": "warp_correlate_bwd_",  # K4: copy, body, planar write
    "warp_correlate_wsum_bwd": "warp_correlate_wsum_bwd_",  # K8: the same three
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Profile the inference forward or a train step (PyTorch/CUDA)")
    p.add_argument("--logdir", default="", help="write a Chrome trace here")
    p.add_argument("--train", action="store_true", help="profile train steps instead of forwards")
    p.add_argument("--nviews", type=int, default=5)
    p.add_argument("--ndepths", default="48,32,8")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--fused", action="store_true", help="fused_view_sum=True (bf16 stages 2-3 via K7/K8)")
    p.add_argument("--remat", action="store_true", help="ModelConfig.remat (train steps recompute activations)")
    p.add_argument("--dense_cost_reg", type=int, choices=[0, 1], default=None,
                   help="1: CostRegNetDense, 0: the 3-D CostRegNet (default: the config's)")
    p.add_argument("--split_cost_reg", action="store_true",
                   help="each cost regulariser's forward device time by part (convs, weight einsum, BatchNorm, rest)")
    p.add_argument("--height", type=int, default=0, help="0 = 512 with --train, 864 without")
    p.add_argument("--width", type=int, default=0, help="0 = 640 with --train, 1152 without")
    p.add_argument("--batch_size", type=int, default=0, help="0 = 2 with --train, 1 without")
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


@contextlib.contextmanager
def split_cost_reg(model):
    """Inside the block, each cost regulariser's forward runs in a
    ``record_function`` range "cost_reg_stageN", and within it every conv
    call, weight einsum and BatchNorm in a range of its own
    ("cost_reg_stageN/conv", ".../weights", ".../batchnorm"), with the card
    synchronised at each range's ends, so that each kernel falls in the
    innermost range its start lies in (``split_totals``). What lies in no
    part (ReLU, skip additions, the banded weight's cast, layout copies) is
    the stage's "rest"."""
    import torch.nn.functional as F
    from torch.autograd.profiler import record_function

    from transmvsnet_tpu_torch.models.blocks import BatchNorm

    stack = []

    def enter(label):
        torch.cuda.synchronize()
        r = record_function(label)
        r.__enter__()
        stack.append((label, r))

    def leave():
        torch.cuda.synchronize()
        stack.pop()[1].__exit__(None, None, None)

    def part(fn, name):
        def run(*args, **kwargs):
            if not stack:
                return fn(*args, **kwargs)
            enter(f"{stack[0][0]}/{name}")
            try:
                return fn(*args, **kwargs)
            finally:
                leave()
        return run

    patched = [(F, n, "conv") for n in ("conv2d", "conv_transpose2d", "conv3d", "conv_transpose3d")]
    patched.append((torch, "einsum", "weights"))
    originals = [(owner, n, getattr(owner, n)) for owner, n, _ in patched]
    for owner, n, name in patched:
        setattr(owner, n, part(getattr(owner, n), name))
    handles = []
    for i, reg in enumerate(model.cost_regularization):
        handles.append(reg.register_forward_pre_hook(lambda m, a, i=i: enter(f"cost_reg_stage{i + 1}")))
        handles.append(reg.register_forward_hook(lambda m, a, o: leave()))
        for bn in (m for m in reg.modules() if isinstance(m, BatchNorm)):
            handles.append(bn.register_forward_pre_hook(
                lambda m, a: enter(f"{stack[0][0]}/batchnorm") if stack else None))
            handles.append(bn.register_forward_hook(lambda m, a, o: leave() if stack else None))
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        for owner, n, fn in originals:
            setattr(owner, n, fn)


def split_totals(events, kernels, passes: int) -> dict:
    """Device milliseconds and launches per pass of each "cost_reg_*" range
    of ``split_cost_reg``: each kernel counted in the innermost range its
    start lies in, a stage's total over its parts and "rest"."""
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.name.startswith("cost_reg_stage")), key=lambda r: r[1] - r[0])
    out: dict = {}
    for k in kernels:
        t = k.time_range.start
        label = next((name for s, e, name in ranges if s <= t <= e), None)
        if label is None:
            continue
        stage, _, name = label.partition("/")
        entry = out.setdefault(stage, {"ms_per_pass": 0.0, "launches_per_pass": 0.0}).setdefault(
            name or "rest", {"ms_per_pass": 0.0, "launches_per_pass": 0.0, "top": defaultdict(float)})
        us = k.time_range.elapsed_us()
        entry["ms_per_pass"] += us / 1e3 / passes
        entry["launches_per_pass"] += 1 / passes
        entry["top"][k.name[:100]] += us / 1e3 / passes
        out[stage]["ms_per_pass"] += us / 1e3 / passes
        out[stage]["launches_per_pass"] += 1 / passes
    for parts in out.values():
        for entry in parts.values():
            if isinstance(entry, dict):
                entry["top"] = sorted(entry["top"].items(), key=lambda kv: -kv[1])[:4]
    return out


def port_kernel_totals(by_name: dict, passes: int) -> dict:
    """ms and launches per pass of each of ``PORT_KERNELS`` from a trace's
    {launch name: [microseconds, launches]}."""
    return {
        k: {"ms_per_pass": sum(v[0] for n, v in by_name.items() if part in n) / 1e3 / passes,
            "launches_per_pass": sum(v[1] for n, v in by_name.items() if part in n) / passes}
        for k, part in PORT_KERNELS.items()
    }


def pass_shape(args) -> tuple[int, int, int]:
    """(batch, height, width) of a pass: the flags, else the DTU recipe for
    training and the DTU eval setting for inference."""
    default = (2, 512, 640) if args.train else (1, 864, 1152)
    return tuple(given or d for given, d in zip((args.batch_size, args.height, args.width), default))


def main(argv=None):
    args = parse_args(argv)
    batch_size, height, width = pass_shape(args)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA card; torch.cuda.is_available() is false")
    from torch.profiler import ProfilerActivity, profile

    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.example import example_train_batch
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.train.loop import to_device_batch
    from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
    from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

    dev = torch.device("cuda", 0)
    cfg = ModelConfig(ndepths=tuple(int(x) for x in args.ndepths.split(",")),
                      compute_dtype=args.dtype, fused_view_sum=args.fused, remat=args.remat)
    if args.dense_cost_reg is not None:
        cfg = dataclasses.replace(cfg, dense_cost_reg=bool(args.dense_cost_reg))
    model = TransMVSNet(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    batch = to_device_batch(example_train_batch(B=batch_size, V=args.nviews, H=height, W=width), dev)

    if args.train:
        state = TrainState(model, *make_optimizer(model.parameters(), warmup_multistep(1e-3, [10**6], 0.5)))
        train_step = make_train_step()

        def forward():
            train_step(state, batch)
    else:
        model.eval()

        def forward():
            with torch.no_grad():
                model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])

    for _ in range(args.warmup):
        forward()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    split = split_cost_reg(model) if args.split_cost_reg else contextlib.nullcontext()
    with split, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.iters):
            forward()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / args.iters

    # (Device-side copies of the split's ranges, where the trace has them,
    # are not launches.)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("cost_reg_stage")]
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
        "pass": "train_step" if args.train else "forward",
        "shape": [batch_size, args.nviews, height, width],
        "ndepths": list(cfg.ndepths),
        "dtype": cfg.compute_dtype,
        "fused_view_sum": cfg.fused_view_sum,
        "remat": cfg.remat,
        "dense_cost_reg": cfg.dense_cost_reg,
        "split_cost_reg": args.split_cost_reg,
        "wall_ms_per_pass": wall_ms,
        "device_busy_ms_per_pass": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms,
        "kernel_launches_per_pass": len(kernels) / args.iters,
        "top_kernels": [
            {"name": name[:120], "ms_per_pass": us / 1e3 / args.iters,
             "launches_per_pass": n / args.iters}
            for name, (us, n) in top
        ],
        "port_kernels": port_kernel_totals(by_name, args.iters),
        # Launches of 1 ms or more in the first traced pass, in order.
        "long_launches": [
            [e.name[:80], e.time_range.elapsed_us() / 1e3] for e in first
            if e.time_range.elapsed_us() >= 1e3
        ],
    }
    if args.split_cost_reg:
        result["cost_reg_by_part"] = split_totals(prof.events(), kernels, args.iters)
    print(json.dumps(result))
    if args.logdir:
        os.makedirs(args.logdir, exist_ok=True)
        name = ("train_step" if args.train else "forward") + ("_fused" if args.fused else "") + "_trace.json"
        prof.export_chrome_trace(os.path.join(args.logdir, name))


if __name__ == "__main__":
    main()
