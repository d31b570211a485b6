"""Time the DCN backward kernel K3 (``csrc/dcn_bwd.cu``) against another
source of the same C entry point, on one card, in turns: typically the
kernel of an earlier commit.

    git show <commit>:transmvsnet_tpu_torch/csrc/dcn_bwd.cu > build/baseline/dcn_bwd.cu
    python -m transmvsnet_tpu_torch.tools.compare_dcn_bwd --baseline build/baseline/dcn_bwd.cu [--steps]

Both sources export ``dcn_bwd(...)`` with the arguments that
``ops/cuda/dcn_bwd.py`` passes, so the baseline runs under the same
wrapper, with the library that the wrapper calls swapped.

1. Kernel: each build at the five DCN shapes of the training path (the ARF
   heads at the DTU recipe, 2 batches x 5 views at 512x640), in bf16 and
   float32, at zero offsets (every tap on an integer), at random offsets of
   0.01 px (off the integers, as the zero-initialised offset convs are after
   a few steps) and of 2 px; each build is first held to the plain version
   on those inputs (the tolerance of ``chip_smoke.py``), then timed by CUDA
   events in turns (baseline, this tree, this tree, baseline). ms per
   shape, and per step: each shape's ms times its launches per step.
2. ``--steps``: the training step at the DTU recipe in bf16, float32 and
   bf16 with the fused view sum, from seeded random weights, with each
   build as K3 in turns (baseline, this tree, this tree, baseline; a few
   steps each, in PyTorch's default arithmetic as the train CLI runs):
   ms per step split into forward (with the loss), backward and optimizer.

Prints one JSON line per phase, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import pathlib
import subprocess

import torch

# (h, w, C_out, launches per step) of the ARF heads' nine DCN layers at
# 512x640; C = 32 in, 2 batches x 5 views.
SHAPES = [(128, 160, 32, 3), (256, 320, 32, 2), (256, 320, 16, 1), (512, 640, 32, 2), (512, 640, 8, 1)]
C, N = 32, 10
OFFSETS = (0.0, 0.01, 2.0)  # standard deviation of the random offsets, in pixels
ROUNDS = 2       # pairs of turns: baseline, this tree, this tree, baseline
ITERS = 5        # kernel calls timed per turn
TRAIN_STEPS = 3  # training steps timed per turn


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Time K3 against another build of dcn_bwd.cu")
    p.add_argument("--baseline", required=True, help="path of the other dcn_bwd.cu")
    p.add_argument("--steps", action="store_true", help="also time the training steps in turns")
    return p.parse_args(argv)


def build_baseline(src: pathlib.Path) -> ctypes.CDLL:
    """Compile ``src`` with the port's nvcc flags into build/kernels."""
    from transmvsnet_tpu_torch.ops.cuda import build

    code = src.read_bytes()
    target = build.BUILD_DIR / f"baseline-dcn_bwd-{hashlib.sha256(code).hexdigest()[:12]}.so"
    if not target.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(target), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(target))


@contextlib.contextmanager
def k3_library(lib):
    """``ops/cuda/dcn_bwd.py`` calls ``lib`` inside the block."""
    from transmvsnet_tpu_torch.ops.cuda import build

    own = build.library("dcn_bwd")
    build._libraries["dcn_bwd"] = lib
    try:
        yield
    finally:
        build._libraries["dcn_bwd"] = own


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
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


def in_turns(libs: dict, fn) -> dict:
    """fn() with each library as K3, in turns (baseline, this, this,
    baseline, ...); each entry lists its rounds' results."""
    out = {name: [] for name in libs}
    order = list(libs)
    for r in range(2 * ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            with k3_library(libs[name]):
                out[name].append(fn())
    return out


def kernel_phase(libs: dict, dev) -> dict:
    from transmvsnet_tpu_torch.ops.cuda.dcn_bwd import dcn_bwd, dcn_bwd_plain

    gen = torch.Generator().manual_seed(1)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for h, w, c_out, per_step in SHAPES:
            def rnd(*shape, s=1.0):
                return (torch.randn(*shape, generator=gen) * s).to(dev)

            x = rnd(N, C, h, w).to(dtype)
            mask = torch.rand(N, 9, h, w, generator=gen).to(dev)
            weight = rnd(9, C, c_out, s=0.1)
            g = rnd(N, c_out, h, w)
            for off in OFFSETS:
                call = (x, rnd(N, 9, h, w, s=off), rnd(N, 9, h, w, s=off), mask, weight, g)
                want = dcn_bwd_plain(*call)
                for name, lib in libs.items():
                    with k3_library(lib):
                        got = dcn_bwd(*call)
                    for a, b in zip(got, want):
                        tol = 1e-3 * b.abs() + 1e-4 * b.abs().max()
                        bad = int(((a - b).abs() > tol).sum())
                        if bad:
                            raise AssertionError(f"{name} K3 disagrees with the plain version at "
                                                 f"{dtype} {(N, C, h, w, c_out)} offsets {off}: {bad}")
                del got, want
                ms = in_turns(libs, lambda: cuda_ms(lambda: dcn_bwd(*call), ITERS))
                row = {"dtype": str(dtype).split(".")[-1], "shape": [N, C, h, w, c_out], "offsets": off,
                       "per_step": per_step, "ms": {k: sum(v) / len(v) for k, v in ms.items()},
                       "ms_turns": ms}
                rows.append(row)
                print(f"K3 {row['dtype']} {row['shape']} offsets {off}: "
                      + " ".join(f"{k} {v:.4f} ms" for k, v in row["ms"].items()), flush=True)
            del x, mask, weight, g, call
            torch.cuda.empty_cache()
    per_step = {}
    for r in rows:
        key = f"{r['dtype']}_offsets_{r['offsets']:g}"
        for name, ms in r["ms"].items():
            per_step.setdefault(key, {}).setdefault(name, 0.0)
            per_step[key][name] += ms * r["per_step"]
    for key, v in per_step.items():
        v["this_over_baseline"] = v["this"] / v["baseline"]
        print(f"K3 per step {key}: baseline {v['baseline']:.4f} ms this {v['this']:.4f} ms "
              f"ratio {v['this_over_baseline']:.4f}", flush=True)
    return {"per_step_ms": per_step, "shapes": rows}


def step_phase(libs: dict, dev) -> dict:
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.example import example_train_batch
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.train.loop import to_device_batch
    from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
    from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

    out = {}
    for label, dtype_name, fused in (("bf16", "bfloat16", False), ("float32", "float32", False),
                                     ("bf16_fused", "bfloat16", True)):
        cfg = ModelConfig(ndepths=(48, 32, 8), compute_dtype=dtype_name, fused_view_sum=fused)
        model = TransMVSNet(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        batch = to_device_batch(example_train_batch(B=2, V=5, H=512, W=640, num_hyp=192), dev)
        state = TrainState(model, *make_optimizer(model.parameters(), warmup_multistep(1e-3, [10**6], 0.5)))
        train_step = make_train_step()

        def timed():
            marks = {k: [] for k in ("start", "forward", "backward", "optimizer")}

            def mark(phase):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks[phase].append(e)

            for _ in range(TRAIN_STEPS):
                mark("start")
                train_step(state, batch, mark)
            torch.cuda.synchronize()
            split = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
            for i in range(TRAIN_STEPS):
                prev = marks["start"][i]
                for phase in split:
                    split[phase] += prev.elapsed_time(marks[phase][i]) / TRAIN_STEPS
                    prev = marks[phase][i]
            return {"ms_per_step": sum(split.values()), **split}

        # PyTorch's default arithmetic (cuDNN may use TF32), as tools/train.py.
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            timed()  # warm-up: cuDNN plans, the allocator
            turns = in_turns(libs, timed)
        mean = {name: {k: sum(t[k] for t in v) / len(v) for k in v[0]} for name, v in turns.items()}
        spread = {name: max(t["ms_per_step"] for t in v) - min(t["ms_per_step"] for t in v)
                  for name, v in turns.items()}
        out[label] = {"mean": mean, "spread_ms_per_step": spread, "turns": turns,
                      "this_over_baseline": mean["this"]["ms_per_step"] / mean["baseline"]["ms_per_step"]}
        print(f"step {label}: " + json.dumps({k: out[label][k] for k in ("mean", "spread_ms_per_step",
                                                                       "this_over_baseline")}), flush=True)
        del model, batch, state
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("comparing kernels needs a CUDA card; torch.cuda.is_available() is false")
    from transmvsnet_tpu_torch.ops.cuda import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    # Comparisons in full float32; the steps are timed in the CLI's arithmetic.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all()
    libs = {"baseline": build_baseline(pathlib.Path(args.baseline)), "this": build.library("dcn_bwd")}
    head = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print(json.dumps({**head, "phase": "kernel", **kernel_phase(libs, dev)}), flush=True)
    if args.steps:
        print(json.dumps({**head, "phase": "steps", **step_phase(libs, dev)}), flush=True)


if __name__ == "__main__":
    main()
