"""Time the DCN kernels (K1 ``csrc/dcn_fused.cu``, K5 ``csrc/dcn.cu`` and K3
``csrc/dcn_bwd.cu``), the warp-correlation forward (K2/K6 and K7,
``csrc/warp_correlate.cu``) and backward (K4 and K8,
``csrc/warp_correlate_bwd.cu``) against another build of the same sources,
on one card, in turns: typically the kernels of an earlier commit.

    git archive <commit> transmvsnet_tpu_torch/csrc | tar -x -C build/baseline
    python -m transmvsnet_tpu_torch.tools.compare_dcn \\
        --baseline build/baseline/transmvsnet_tpu_torch/csrc [--warp] [--warp-fwd] [--steps] [--forwards]

The baseline directory holds the other sources (and any header they
include); each exports the C entry point that the wrappers in ``ops/cuda/``
call, so the baseline runs under the same wrappers, with the libraries that
they call swapped. K2/K6's, K7's, K4's and K8's entry points take
trailing arguments (scratch, K8's dvw flag) that the builds before them
lack: under the x86-64 calling convention such a build ignores them, and
the wrappers keep its contract (zeroed outputs, a dvw buffer), so it
computes dvw always, as its steps did.

1. Kernels, each build first held to the plain version on the same inputs
   (the tolerances of ``chip_smoke.py``), then timed by CUDA events in turns
   (baseline, this tree, this tree, baseline):
   - K1 (bf16) and K5 (float32 and bf16) at the five DCN shapes of the
     inference path (5 views at 1152x864) and of the training path (2
     batches x 5 views at 512x640), at three offset regimes (see
     ``FWD_REGIMES``);
   - K3 (bf16 and float32) at the training shapes, at zero offsets, random
     offsets of 0.01 px (off the integers, as the zero-initialised offset
     convs are after a few steps) and of 2 px.
   ms per shape, and per pass: each shape's ms times its launches per
   forward (inference) or per step (training).
2. ``--steps``: the training step at the DTU recipe in bf16, float32 and bf16
   with the fused view sum, from seeded random weights, with each build in
   turns (a few steps each, in PyTorch's default arithmetic as the train CLI
   runs): ms per step split into forward (with the loss), backward and
   optimizer.
3. ``--forwards``: the inference forward at 1152x864, 5 views, in bf16,
   float32 and bf16 with the fused view sum (offset convs with random
   weights, as ``chip_smoke.py`` sets them), with each build in turns: ms
   per depth map.
4. ``--warp``: K4 (bf16 and float32) and K8 (with and without dvw), each
   build held to the plain version (``chip_smoke.py``'s gate) and timed in
   turns, on two kinds of inputs:
   - the checks' inputs (``sweep_inputs``: random features, per-pixel
     noise on the hypotheses, a band behind the cameras) at the training
     path's three plane sweeps (K8 at stages 2-3, where it runs);
   - the arguments of every K4/K8 call of one real training step, in bf16,
     float32 and bf16 with the fused view sum, captured after two Adam
     steps from seeded weights (``capture_step_calls``); K8's calls as the
     step makes them (without dvw) and again with dvw.
   ms per shape and per step (each shape's ms summed over a step's calls),
   beside the share of samples that land on the source image.
5. ``--warp-fwd``: K2 (bf16), K6 (float32) and K7 (the fused view sum),
   each build held to the plain version (``chip_smoke.py``'s gate) and
   timed in turns, on two kinds of inputs:
   - the checks' inputs (``sweep_inputs``) at the three plane sweeps of the
     inference and the training path (K7 at stages 2-3);
   - the arguments of every K2/K6 and K7 call of one real inference
     forward at 1152x864, 5 views, in bf16, float32 and bf16 with the fused
     view sum, from seeded weights (``capture_forward_calls``).
   ms per shape and per forward (each shape's ms summed over a forward's
   calls): the device time of the kernels' launches alone, replayed from a
   CUDA graph (``kernel_ms``), since the wrappers' host time per call
   exceeds these kernels'; beside it the wrapper's wall time per call, the
   share of samples that land on the source image, whether this tree's
   every turn was faster than the baseline's every turn, and whether the
   two builds' outputs are equal bit for bit.

Prints one JSON line per phase, each with the card's name and power limit;
``--no-kernels`` skips phase 1 (to time only the other phases in a shorter
run).
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

# The libraries a build provides: the wrappers' names for csrc/<name>.cu.
LIBRARIES = ("dcn_fused", "dcn", "dcn_bwd", "warp_correlate", "warp_correlate_bwd")
C, V = 32, 5
# (batch, height, width) of each path that runs the DCN kernels.
PATHS = {"inference": (1, 864, 1152), "train": (2, 512, 640)}
# Forward offset regimes: the offset conv's (weight, bias) scales. "zero":
# the training path's initial state, every tap on an integer; "inference":
# what chip_smoke.py's inference paths set (offsets of a pixel or two,
# nearly constant per tap); "checks": larger per-pixel spread (K1's conv
# 0.12 / 0.5; K5 given random offsets of 1.5 px and masks in (0, 1)). K5's
# other regimes take the offsets and masks of the same conv.
FWD_REGIMES = {"zero": (0.0, 0.0), "inference": (0.05, 1.5), "checks": (0.12, 0.5)}
FWD_KERNELS = ("dcn_fused", "dcn_f32", "dcn_bf16")
BWD_OFFSETS = (0.0, 0.01, 2.0)  # standard deviation of K3's random offsets, in pixels
ROUNDS = 2       # pairs of turns: baseline, this tree, this tree, baseline
ITERS = 5        # kernel calls timed per turn
TRAIN_STEPS = 3  # training steps timed per turn
REQUESTS = 3     # inference forwards timed per turn
# The training path's plane sweeps: (stage, C, D); K8 runs at stages 2-3.
SWEEPS = (("stage1", 32, 48), ("stage2", 16, 32), ("stage3", 8, 8))
# The training steps that --steps times and whose K4/K8 calls --warp
# captures, and the forwards that --forwards times: (label, dtype, fused
# view sum).
STEP_CONFIGS = (("bf16", "bfloat16", False), ("float32", "float32", False), ("bf16_fused", "bfloat16", True))
WARP_GATE = (1e-3, 1e-3)  # rtol, atol_scale: chip_smoke.py's gate for K2, K4, K6, K7 and K8


def head_shapes(h: int, w: int) -> list[tuple[int, int, int, int]]:
    """(h, w, C_out, launches per pass) of the ARF heads' nine DCN layers
    for input images of h x w."""
    return [(h // 4, w // 4, 32, 3), (h // 2, w // 2, 32, 2), (h // 2, w // 2, 16, 1),
            (h, w, 32, 2), (h, w, 8, 1)]


def forward_inputs(kernel: str, regime: str, gen, dev, N: int, h: int, w: int, c_out: int):
    """(wrapper, plain version, arguments, (rtol, atol_scale)) of one
    forward kernel ("dcn_fused", "dcn_f32" or "dcn_bf16") at one shape and
    regime, C = 32 channels in."""
    from transmvsnet_tpu_torch.ops.cuda.dcn import deform_conv2d, deform_conv2d_plain
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused, dcn_fused_plain
    from transmvsnet_tpu_torch.ops.dcn import offset_conv, split_offsets

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(dev)

    dtype = torch.float32 if kernel == "dcn_f32" else torch.bfloat16
    x = rnd(N, C, h, w).to(dtype)
    k_scale, b_scale = FWD_REGIMES[regime]
    k_off, b_off = rnd(27, C, 3, 3, s=k_scale), rnd(27, s=b_scale)
    weight, bias = rnd(9, C, c_out, s=0.1), rnd(c_out, s=0.1)
    # Both sides round one float32 result to bf16 (one bf16 step apart at
    # most, plus summation-order noise), or both are float32.
    tol = (2.0**-7, 1e-3) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    if kernel == "dcn_fused":
        return dcn_fused, dcn_fused_plain, (x, k_off, b_off, weight, bias), tol
    if regime == "checks":
        dy, dx = rnd(N, 9, h, w, s=1.5), rnd(N, 9, h, w, s=1.5)
        mask = torch.rand(N, 9, h, w, generator=gen).to(dev)
    else:
        dy, dx, mask = (t.contiguous() for t in split_offsets(offset_conv(x.float(), k_off, b_off)))
    return deform_conv2d, deform_conv2d_plain, (x, dy, dx, mask, weight, bias), tol


def outside(got, want, rtol: float, atol_scale: float) -> int:
    """Elements with |got - want| > rtol |want| + atol_scale max|want|."""
    got, want = got.float(), want.float()
    return int(((got - want).abs() > rtol * want.abs() + atol_scale * want.abs().max()).sum())


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Time the port's kernels against another build of their sources")
    p.add_argument("--baseline", required=True, help="directory of the other build's sources (LIBRARIES)")
    p.add_argument("--steps", action="store_true", help="also time the training steps in turns")
    p.add_argument("--forwards", action="store_true", help="also time the inference forwards in turns")
    p.add_argument("--warp", action="store_true", help="also time K4 and K8 in turns")
    p.add_argument("--warp-fwd", action="store_true", help="also time K2, K6 and K7 in turns")
    p.add_argument("--no-kernels", action="store_true", help="skip phase 1 (with --steps or --forwards)")
    return p.parse_args(argv)


def build_baseline(src_dir: pathlib.Path) -> dict:
    """Compile the sources of ``src_dir`` named in LIBRARIES with the port's
    nvcc flags into build/kernels, all at once; name -> loaded library."""
    from transmvsnet_tpu_torch.ops.cuda import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(src_dir.glob("*.cu*")))).hexdigest()[:12]
    jobs = {}
    for name in LIBRARIES:
        target = build.BUILD_DIR / f"baseline-{name}-{digest}.so"
        proc = None
        if not target.exists():
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(target), str(src_dir / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (target, proc)
    libs = {}
    for name, (target, proc) in jobs.items():
        if proc is not None:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src_dir / name}.cu:\n{out}")
        libs[name] = ctypes.CDLL(str(target))
    return libs


@contextlib.contextmanager
def using(libs: dict):
    """The wrappers in ``ops/cuda/`` call ``libs`` inside the block."""
    from transmvsnet_tpu_torch.ops.cuda import build

    own = {name: build.library(name) for name in libs}
    build._libraries.update(libs)
    try:
        yield
    finally:
        build._libraries.update(own)


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


def kernel_ms(launch, iters: int = ITERS, replays: int = 3) -> float:
    """Device milliseconds per call of ``launch``, a closure that only
    launches kernels: ``iters`` calls captured in a CUDA graph, the graph
    replayed and timed by CUDA events, so the host's time per call (which
    can exceed a small kernel's) does not enter."""
    launch()  # loads the kernels' module before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            launch()
    graph.replay()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def warp_fwd_launch(kernel: str, args):
    """A closure that launches K2/K6 ("warp_correlate", "warp_correlate_f32")
    or K7 ("warp_correlate_wsum") of the current build on ``args`` (as the
    wrappers take them) and nothing else: outputs, scratch and projection
    rows are made once, as the wrappers make them."""
    from transmvsnet_tpu_torch.ops.cuda import build
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
        forward_scratch,
        launch_forward,
        launch_wsum_forward,
        relative_rows,
    )

    src, ref, sp, rp, depth = args[:5]
    B, S, _, H, W = src.shape
    rel = relative_rows(sp, rp)
    src_cl = forward_scratch(src)
    lib = build.library("warp_correlate")
    if kernel == "warp_correlate_wsum":
        out = torch.empty((B, depth.shape[1], H, W), dtype=torch.float32, device=src.device)
        return lambda: build.check(lib, "warp_correlate", launch_wsum_forward(
            lib, src, ref, rel, depth, args[5], out, src_cl, build.stream_handle(src)))
    out = torch.empty((B, S, depth.shape[1], H, W), dtype=torch.float32, device=src.device)
    return lambda: build.check(lib, "warp_correlate", launch_forward(
        lib, src, ref, rel, depth, out, src_cl, build.stream_handle(src)))


def in_turns(builds: dict, fn) -> dict:
    """fn() with each build's libraries, in turns (baseline, this, this,
    baseline, ...); each entry lists its rounds' results."""
    out = {name: [] for name in builds}
    order = list(builds)
    for r in range(2 * ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            with using(builds[name]):
                out[name].append(fn())
    return out


def per_pass(rows: list, keys) -> dict:
    """Sum over shapes of ms times launches per pass, per group of rows
    (the values of ``keys``) and build; with this tree over the baseline."""
    out: dict = {}
    for r in rows:
        key = "_".join(str(r[k]) for k in keys)
        for name, ms in r["ms"].items():
            out.setdefault(key, {}).setdefault(name, 0.0)
            out[key][name] += ms * r["per_pass"]
    for v in out.values():
        v["this_over_baseline"] = v["this"] / v["baseline"]
    return out


def check_builds(builds: dict, fn, args, want, tol, what: str) -> bool:
    """Raise unless each build's ``fn(*args)`` is within ``tol`` of
    ``want``; returns whether the builds' outputs are equal bit for bit."""
    outs = []
    for name, libs in builds.items():
        with using(libs):
            got = fn(*args)
        bad = outside(got, want, *tol)
        if bad:
            raise AssertionError(f"{name} disagrees with the plain version at {what}: {bad} outside")
        outs.append(got)
    return all(torch.equal(outs[0], o) for o in outs[1:])


def forward_phase(builds: dict, dev) -> dict:
    gen = torch.Generator().manual_seed(1)
    rows = []
    for kernel in FWD_KERNELS:
        for path, (b, ph, pw) in PATHS.items():
            for h, w, c_out, launches in head_shapes(ph, pw):
                for regime in FWD_REGIMES:
                    N = b * V
                    fn, plain, args, tol = forward_inputs(kernel, regime, gen, dev, N, h, w, c_out)
                    with torch.no_grad():
                        check_builds(builds, fn, args, plain(*args), tol, f"{kernel} {path} {[N, C, h, w, c_out]} {regime}")
                        ms = in_turns(builds, lambda: cuda_ms(lambda: fn(*args), ITERS))
                    row = {"kernel": kernel, "path": path, "regime": regime, "shape": [N, C, h, w, c_out],
                           "per_pass": launches, "ms": {k: sum(v) / len(v) for k, v in ms.items()}, "ms_turns": ms}
                    rows.append(row)
                    print(f"{kernel} {path} {row['shape']} {regime}: "
                          + " ".join(f"{k} {v:.4f} ms" for k, v in row["ms"].items()), flush=True)
                    del args
                torch.cuda.empty_cache()
    totals = per_pass(rows, ("kernel", "path", "regime"))
    for key, v in totals.items():
        print(f"per pass {key}: baseline {v['baseline']:.4f} ms this {v['this']:.4f} ms "
              f"ratio {v['this_over_baseline']:.4f}", flush=True)
    return {"per_pass_ms": totals, "shapes": rows}


def backward_phase(builds: dict, dev) -> dict:
    from transmvsnet_tpu_torch.ops.cuda.dcn_bwd import dcn_bwd, dcn_bwd_plain

    gen = torch.Generator().manual_seed(1)
    b, ph, pw = PATHS["train"]
    N = b * V
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for h, w, c_out, launches in head_shapes(ph, pw):
            def rnd(*shape, s=1.0):
                return (torch.randn(*shape, generator=gen) * s).to(dev)

            x = rnd(N, C, h, w).to(dtype)
            mask = torch.rand(N, 9, h, w, generator=gen).to(dev)
            weight = rnd(9, C, c_out, s=0.1)
            g = rnd(N, c_out, h, w)
            for off in BWD_OFFSETS:
                call = (x, rnd(N, 9, h, w, s=off), rnd(N, 9, h, w, s=off), mask, weight, g)
                want = dcn_bwd_plain(*call)
                for name, libs in builds.items():
                    with using(libs):
                        got = dcn_bwd(*call)
                    bad = sum(outside(a, b_, 1e-3, 1e-4) for a, b_ in zip(got, want))
                    if bad:
                        raise AssertionError(f"{name} K3 disagrees with the plain version at "
                                             f"{dtype} {(N, C, h, w, c_out)} offsets {off}: {bad}")
                del got, want
                ms = in_turns(builds, lambda: cuda_ms(lambda: dcn_bwd(*call), ITERS))
                row = {"kernel": "dcn_bwd" + ("_f32" if dtype == torch.float32 else ""),
                       "offsets": off, "shape": [N, C, h, w, c_out], "per_pass": launches,
                       "ms": {k: sum(v) / len(v) for k, v in ms.items()}, "ms_turns": ms}
                rows.append(row)
                print(f"{row['kernel']} {row['shape']} offsets {off}: "
                      + " ".join(f"{k} {v:.4f} ms" for k, v in row["ms"].items()), flush=True)
            del x, mask, weight, g, call
            torch.cuda.empty_cache()
    totals = per_pass(rows, ("kernel", "offsets"))
    for key, v in totals.items():
        print(f"per step {key}: baseline {v['baseline']:.4f} ms this {v['this']:.4f} ms "
              f"ratio {v['this_over_baseline']:.4f}", flush=True)
    return {"per_step_ms": totals, "shapes": rows}


def sweep_inputs(gen, dev, b, ph, pw, stage_index, stage, C, D, dtype):
    """Features, hypotheses and fused projections of one plane sweep for
    b batches of V views at ph x pw: random features in ``dtype``,
    hypotheses across the DTU range with 5 mm of per-pixel noise and a band
    behind the cameras (source z < 1e-6)."""
    from transmvsnet_tpu_torch.data.example import DEPTH_MAX, DEPTH_MIN, example_inputs
    from transmvsnet_tpu_torch.ops.geometry import fuse_projection

    _, projs, _ = example_inputs(B=b, V=V, H=ph, W=pw)
    scale = 2 ** (2 - stage_index)
    h, w = ph // scale, pw // scale
    src = torch.randn(b, V - 1, C, h, w, generator=gen).to(dev, dtype)
    ref = torch.randn(b, C, h, w, generator=gen).to(dev, dtype)
    base = torch.linspace(DEPTH_MIN, DEPTH_MAX, D)[None, :, None, None]
    depth = base + 5.0 * torch.rand(b, D, h, w, generator=gen)
    depth[:, :, : h // 16] *= -1.0
    depth = depth.to(dev).contiguous()
    fused = fuse_projection(torch.from_numpy(projs[stage]).to(dev))
    return src, ref, fused[:, 1:].contiguous(), fused[:, 0].contiguous(), depth


def capture_step_calls(dev, dtype_name: str, fused: bool, warm_steps: int = 2, shape=None,
                       ndepths=(48, 32, 8)) -> list:
    """The arguments of every K4/K8 call of one training step at the DTU
    recipe (``shape`` = (batch, height, width), the training path's by
    default), after ``warm_steps`` Adam steps from seeded weights: a list of
    (kernel, stage, args, need_dvw) in call order, the arguments cloned;
    kernel is "warp_correlate_bwd" (K4) or "warp_correlate_wsum_bwd" (K8)
    and stage "stage1".. by resolution, coarsest first."""
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.example import example_train_batch
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.ops import vjp
    from transmvsnet_tpu_torch.train.loop import to_device_batch
    from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
    from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

    b, ph, pw = shape or PATHS["train"]
    cfg = ModelConfig(ndepths=ndepths, compute_dtype=dtype_name, fused_view_sum=fused)
    model = TransMVSNet(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    batch = to_device_batch(example_train_batch(B=b, V=V, H=ph, W=pw, num_hyp=192), dev)
    state = TrainState(model, *make_optimizer(model.parameters(), warmup_multistep(1e-3, [10**6], 0.5)))
    train_step = make_train_step()
    calls = []

    def spy(name, fn):
        def call(*args, need_dvw=None):
            calls.append((name, tuple(a.detach().clone() for a in args), need_dvw))
            return fn(*args) if need_dvw is None else fn(*args, need_dvw=need_dvw)
        return call

    # The train CLI's arithmetic (cuDNN may use TF32).
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        for _ in range(warm_steps):
            train_step(state, batch)
        own = vjp.warp_correlate_bwd, vjp.warp_correlate_wsum_bwd
        vjp.warp_correlate_bwd = spy("warp_correlate_bwd", own[0])
        vjp.warp_correlate_wsum_bwd = spy("warp_correlate_wsum_bwd", own[1])
        try:
            train_step(state, batch)
        finally:
            vjp.warp_correlate_bwd, vjp.warp_correlate_wsum_bwd = own
    heights = sorted({args[0].shape[-2] for _, args, _ in calls})
    return [(name, f"stage{heights.index(args[0].shape[-2]) + 1}", args, need_dvw)
            for name, args, need_dvw in calls]


def valid_share(args) -> float:
    """Share of (view, hypothesis, pixel) samples of a warp call's
    arguments that land on the source image (a nonzero forward)."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate

    with torch.no_grad():
        return (warp_correlate(*args[:5]) != 0).float().mean().item()


def warp_calls(dev) -> list:
    """(kernel, inputs, stage, args, need_dvw) of every row of the --warp
    phase; kernel names as ``chip_smoke.py``'s kernel line, with K8's
    instantiation without dvw as "warp_correlate_wsum_bwd_no_dvw"."""
    gen = torch.Generator().manual_seed(1)
    b, ph, pw = PATHS["train"]
    S = V - 1
    rows = []
    for dtype, kernel in ((torch.bfloat16, "warp_correlate_bwd"), (torch.float32, "warp_correlate_bwd_f32")):
        for i, (stage, C, D) in enumerate(SWEEPS):
            fwd = sweep_inputs(gen, dev, b, ph, pw, i, stage, C, D, dtype)
            g = torch.randn(b, S, D, *fwd[0].shape[-2:], generator=gen).to(dev)
            rows.append((kernel, "checks", stage, (*fwd, g), None))
    for i, (stage, C, D) in list(enumerate(SWEEPS))[1:]:
        fwd = sweep_inputs(gen, dev, b, ph, pw, i, stage, C, D, torch.bfloat16)
        h, w = fwd[0].shape[-2:]
        vw = torch.rand(b, S, h, w, generator=gen).to(dev)
        g = torch.randn(b, D, h, w, generator=gen).to(dev)
        for need_dvw in (True, False):
            rows.append(("warp_correlate_wsum_bwd" + ("" if need_dvw else "_no_dvw"), "checks", stage,
                         (*fwd, vw, g), need_dvw))
    for label, dtype_name, fused in STEP_CONFIGS:
        for name, stage, args, need_dvw in capture_step_calls(dev, dtype_name, fused):
            if name == "warp_correlate_bwd":
                kernel = name + ("_f32" if args[0].dtype == torch.float32 else "")
                rows.append((kernel, f"step_{label}", stage, args, None))
            else:
                for dvw in (True, False):
                    rows.append((name + ("" if dvw else "_no_dvw"), f"step_{label}", stage, args, dvw))
        torch.cuda.empty_cache()
    return rows


def warp_phase(builds: dict, dev) -> dict:
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import (
        warp_correlate_bwd,
        warp_correlate_bwd_plain,
        warp_correlate_wsum_bwd,
        warp_correlate_wsum_bwd_plain,
    )

    rows = []
    for kernel, inputs, stage, args, need_dvw in warp_calls(dev):
        if need_dvw is None:
            fn, plain, kw = warp_correlate_bwd, warp_correlate_bwd_plain, {}
        else:
            fn, plain, kw = warp_correlate_wsum_bwd, warp_correlate_wsum_bwd_plain, {"need_dvw": need_dvw}
        want = [t for t in plain(*args, **kw) if t is not None]
        for name, libs in builds.items():
            with using(libs):
                got = fn(*args, **kw)
            if (got[-1] is None) == need_dvw:
                raise AssertionError(f"{name} {kernel}: dvw returned against need_dvw={need_dvw}")
            bad = sum(outside(a, b_, *WARP_GATE) for a, b_ in zip(got, want))
            if bad:
                raise AssertionError(f"{name} {kernel} disagrees with the plain version at {inputs} {stage}: "
                                     f"{bad} outside")
        del got, want
        ms = in_turns(builds, lambda: cuda_ms(lambda: fn(*args, **kw), ITERS))
        row = {"kernel": kernel, "inputs": inputs, "stage": stage, "shape": list(args[0].shape),
               "D": args[4].shape[1], "per_pass": 1, "valid_share": valid_share(args),
               "ms": {k: sum(v) / len(v) for k, v in ms.items()}, "ms_turns": ms}
        rows.append(row)
        print(f"{kernel} {inputs} {stage} {row['shape']} D {row['D']} valid {row['valid_share']:.3f}: "
              + " ".join(f"{k} {v:.4f} ms" for k, v in row["ms"].items()), flush=True)
        del args
        torch.cuda.empty_cache()
    totals = per_pass(rows, ("kernel", "inputs"))
    for key, v in totals.items():
        print(f"per step {key}: baseline {v['baseline']:.4f} ms this {v['this']:.4f} ms "
              f"ratio {v['this_over_baseline']:.4f}", flush=True)
    return {"per_step_ms": totals, "shapes": rows}


def inference_model(dev, dtype_name: str, fused: bool = False, ndepths=(48, 32, 8)):
    """The cascade in eval mode from seeded weights, its DCN offset convs
    set as ``chip_smoke.py``'s inference paths set them
    (``FWD_REGIMES["inference"]``)."""
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.models.feature_net import DCN
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet

    gen = torch.Generator().manual_seed(0)
    cfg = ModelConfig(ndepths=ndepths, compute_dtype=dtype_name, fused_view_sum=fused)
    model = TransMVSNet(cfg, device=dev, generator=gen).eval()
    k_scale, b_scale = FWD_REGIMES["inference"]
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCN):
                w, bb = m.conv_offset_mask.weight, m.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=gen) * k_scale)
                bb.copy_(torch.randn(bb.shape, generator=gen) * b_scale)
    return model


def capture_forward_calls(dev, dtype_name: str, fused: bool, shape=None, ndepths=(48, 32, 8)) -> list:
    """The arguments of every K2/K6 and K7 call of one inference forward
    (``shape`` = (batch, height, width), the inference path's by default)
    of ``inference_model``: a list of (kernel, stage, args) in call order,
    the arguments cloned; kernel is "warp_correlate" (K2/K6) or
    "warp_correlate_wsum" (K7) and stage "stage1".. by resolution,
    coarsest first."""
    from transmvsnet_tpu_torch.data.example import example_inputs
    from transmvsnet_tpu_torch.ops import vjp

    b, ph, pw = shape or PATHS["inference"]
    model = inference_model(dev, dtype_name, fused, ndepths)
    imgs, projs, dv = example_inputs(B=b, V=V, H=ph, W=pw, num_hyp=192)
    calls = []

    def spy(name, fn):
        def call(*args):
            calls.append((name, tuple(a.detach().clone() for a in args)))
            return fn(*args)
        return call

    own = vjp.warp_correlate, vjp.warp_correlate_wsum
    vjp.warp_correlate = spy("warp_correlate", own[0])
    vjp.warp_correlate_wsum = spy("warp_correlate_wsum", own[1])
    try:
        with torch.no_grad():
            model(torch.from_numpy(imgs).to(dev), {k: torch.from_numpy(v).to(dev) for k, v in projs.items()},
                  torch.from_numpy(dv).to(dev))
    finally:
        vjp.warp_correlate, vjp.warp_correlate_wsum = own
    heights = sorted({args[0].shape[-2] for _, args in calls})
    return [(name, f"stage{heights.index(args[0].shape[-2]) + 1}", args) for name, args in calls]


def warp_fwd_calls(dev) -> list:
    """(kernel, inputs, stage, args) of every row of the --warp-fwd phase;
    kernel names as ``chip_smoke.py``'s kernel line."""
    gen = torch.Generator().manual_seed(1)
    S = V - 1
    rows = []
    for path, (b, ph, pw) in PATHS.items():
        for dtype in (torch.bfloat16, torch.float32):
            kernel = "warp_correlate" + ("_f32" if dtype == torch.float32 else "")
            for i, (stage, C, D) in enumerate(SWEEPS):
                rows.append((kernel, f"checks_{path}", stage, sweep_inputs(gen, dev, b, ph, pw, i, stage, C, D, dtype)))
        for i, (stage, C, D) in list(enumerate(SWEEPS))[1:]:
            fwd = sweep_inputs(gen, dev, b, ph, pw, i, stage, C, D, torch.bfloat16)
            vw = torch.rand(b, S, *fwd[0].shape[-2:], generator=gen).to(dev)
            rows.append(("warp_correlate_wsum", f"checks_{path}", stage, (*fwd, vw)))
    for label, dtype_name, fused in STEP_CONFIGS:
        for name, stage, args in capture_forward_calls(dev, dtype_name, fused):
            kernel = name + ("_f32" if args[0].dtype == torch.float32 else "")
            rows.append((kernel, f"forward_{label}", stage, args))
        torch.cuda.empty_cache()
    return rows


def warp_fwd_phase(builds: dict, dev) -> dict:
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
        warp_correlate,
        warp_correlate_plain,
        warp_correlate_wsum,
        warp_correlate_wsum_plain,
    )

    rows = []
    for kernel, inputs, stage, args in warp_fwd_calls(dev):
        if kernel == "warp_correlate_wsum":
            fn, plain = warp_correlate_wsum, warp_correlate_wsum_plain
        else:
            fn, plain = warp_correlate, warp_correlate_plain
        with torch.no_grad():
            equal = check_builds(builds, fn, args, plain(*args), WARP_GATE, f"{kernel} {inputs} {stage}")
            ms = in_turns(builds, lambda: kernel_ms(warp_fwd_launch(kernel, args)))
            call_ms = in_turns(builds, lambda: cuda_ms(lambda: fn(*args), ITERS))
        row = {"kernel": kernel, "inputs": inputs, "stage": stage, "shape": list(args[0].shape),
               "D": args[4].shape[1], "per_pass": 1, "valid_share": valid_share(args),
               "ms": {k: sum(v) / len(v) for k, v in ms.items()}, "ms_turns": ms,
               "faster_every_turn": max(ms["this"]) < min(ms["baseline"]), "bitwise_equal": equal,
               "call_ms": {k: sum(v) / len(v) for k, v in call_ms.items()}}
        rows.append(row)
        print(f"{kernel} {inputs} {stage} {row['shape']} D {row['D']} valid {row['valid_share']:.3f}: "
              + " ".join(f"{k} {v:.4f} ms" for k, v in row["ms"].items())
              + f" (this faster in every turn: {row['faster_every_turn']}; bitwise equal: {equal})"
              + "; per wrapper call " + " ".join(f"{k} {v:.4f}" for k, v in row["call_ms"].items()), flush=True)
        del args
        torch.cuda.empty_cache()
    totals = per_pass(rows, ("kernel", "inputs"))
    for key, v in totals.items():
        print(f"per forward {key}: baseline {v['baseline']:.4f} ms this {v['this']:.4f} ms "
              f"ratio {v['this_over_baseline']:.4f}", flush=True)
    return {"per_forward_ms": totals, "shapes": rows}


def summarise_turns(turns: dict, key: str) -> dict:
    mean = {name: {k: sum(t[k] for t in v) / len(v) for k in v[0]} for name, v in turns.items()}
    spread = {name: max(t[key] for t in v) - min(t[key] for t in v) for name, v in turns.items()}
    return {"mean": mean, "spread": spread, "turns": turns,
            "this_over_baseline": mean["this"][key] / mean["baseline"][key]}


def step_phase(builds: dict, dev) -> dict:
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.example import example_train_batch
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.train.loop import to_device_batch
    from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
    from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

    out = {}
    b, ph, pw = PATHS["train"]
    for label, dtype_name, fused in STEP_CONFIGS:
        cfg = ModelConfig(ndepths=(48, 32, 8), compute_dtype=dtype_name, fused_view_sum=fused)
        model = TransMVSNet(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        batch = to_device_batch(example_train_batch(B=b, V=V, H=ph, W=pw, num_hyp=192), dev)
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
            out[label] = summarise_turns(in_turns(builds, timed), "ms_per_step")
        print(f"step {label}: " + json.dumps({k: out[label][k] for k in ("mean", "spread", "this_over_baseline")}),
              flush=True)
        del model, batch, state
        torch.cuda.empty_cache()
    return out


def forwards_phase(builds: dict, dev) -> dict:
    from transmvsnet_tpu_torch.data.example import example_inputs

    out = {}
    b, ph, pw = PATHS["inference"]
    imgs, projs, dv = example_inputs(B=b, V=V, H=ph, W=pw, num_hyp=192)
    t_imgs = torch.from_numpy(imgs).to(dev)
    t_projs = {k: torch.from_numpy(v).to(dev) for k, v in projs.items()}
    t_dv = torch.from_numpy(dv).to(dev)
    for label, dtype_name, fused in STEP_CONFIGS:
        model = inference_model(dev, dtype_name, fused)

        def timed():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.no_grad():
                start.record()
                for _ in range(REQUESTS):
                    model(t_imgs, t_projs, t_dv)
                end.record()
            torch.cuda.synchronize()
            return {"ms_per_depth_map": start.elapsed_time(end) / REQUESTS}

        # The inference CLI's arithmetic: float32 in PyTorch's default (cuDNN
        # may use TF32); bf16 as chip_smoke.py times it.
        flags = torch.backends.cudnn.flags(enabled=True, allow_tf32=dtype_name == "float32")
        with flags:
            timed()  # warm-up
            out[label] = summarise_turns(in_turns(builds, timed), "ms_per_depth_map")
        print(f"forward {label}: " + json.dumps({k: out[label][k] for k in ("mean", "spread", "this_over_baseline")}),
              flush=True)
        del model
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("comparing kernels needs a CUDA card; torch.cuda.is_available() is false")
    from transmvsnet_tpu_torch.ops.cuda import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    # Comparisons in full float32; the steps and forwards are timed in the CLIs' arithmetic.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build_all()
    builds = {"baseline": build_baseline(pathlib.Path(args.baseline)),
              "this": {name: build.library(name) for name in LIBRARIES}}
    head = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    if not args.no_kernels:
        print(json.dumps({**head, "phase": "forward_kernels", **forward_phase(builds, dev)}), flush=True)
        print(json.dumps({**head, "phase": "backward_kernel", **backward_phase(builds, dev)}), flush=True)
    if args.warp:
        print(json.dumps({**head, "phase": "warp_backward", **warp_phase(builds, dev)}), flush=True)
    if args.warp_fwd:
        print(json.dumps({**head, "phase": "warp_forward", **warp_fwd_phase(builds, dev)}), flush=True)
    if args.forwards:
        print(json.dumps({**head, "phase": "forwards", **forwards_phase(builds, dev)}), flush=True)
    if args.steps:
        print(json.dumps({**head, "phase": "steps", **step_phase(builds, dev)}), flush=True)


if __name__ == "__main__":
    main()
