"""GPU smoke run of the PyTorch/CUDA port: DTU inference and DTU training,
in bfloat16, in float32 (the JAX package's default), and in bfloat16 with
the fused view sum (``fused_view_sum=True``); then the evaluation pipeline
(read, infer, write, fuse, score) and the training side (two processes,
the training CLI on DTU and BlendedMVS data) through the CLIs; then the
(data, view, depth) mesh in processes sharing the card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this repository's
``transmvsnet_tpu_torch`` package. Phases, in order; any failure raises:

1. Device: the card's name and power limit (nvidia-smi).
2. Build: compile every kernel under ``transmvsnet_tpu_torch/csrc`` and
   the nvJPEG codec ``csrc/image_codec.cu``; print which image packages the
   machine has and the libnvjpeg loaded.
3. Kernel checks: each kernel instantiation against its plain PyTorch
   version on the card, on the same inputs, at every shape its path gives
   it; kernel and plain times by CUDA events. bf16: K1-K4 and the fused
   view sum's K7/K8 (stages 2-3; K8 without dvw, as the fused step runs
   it, and with dvw); float32: K5, K6 and K3/K4's float
   instantiations; K5's bf16 instantiation (row 4, on no model path) at
   the bf16 DCN shapes. K1 and K5 are checked (each also for bitwise
   repeatability) and timed at three offset regimes (see
   ``compare_dcn.FWD_REGIMES``), K1 beside the unfused bf16 route as a
   yardstick; K3 at zero, 2-px and 6-px offsets (see DCN_BWD_OFFSETS). K2,
   K6 and K7 are also checked for bitwise repeatability.
4. Inference paths: the cascade at 1152x864, 5 views, batch 1, 48/32/8
   hypotheses, random weights from a seeded generator, in bfloat16, in
   float32 and in bfloat16 with the fused view sum; a few requests with
   the launch counts read around them; the same model and inputs with the
   plain ops for agreement (the fused path also against the unfused bf16
   kernels); depth-maps/s, peak memory and one forward's time by part of
   the model; the fused path also times itself and its unfused twin in
   turns (as does the fused training path). The float32 requests are timed in PyTorch's default
   arithmetic (cuDNN may use TF32) and compared in full float32. Every
   path runs the config's default cost regulariser (``dense_cost_reg``);
   the bf16 and float32 paths also time it in turns with the other form
   (``CostRegNetDense``, the depth-as-channels 2-D convs, or the 3-D
   ``CostRegNet``) on the same weights, break each form's forward down by
   part (cost_reg_stage1-3) and hold the other form's output to the
   default's (DENSE_AGREE_MIN), beside a planted band fault the gate must
   reject (``planted_band_fault``); the bf16 path also runs one forward with
   FeatureNet once per view (``batch_views_jointly=False``: 45 K1
   launches).
5. Training paths: ``train/step.py`` at the DTU recipe (512x640, 5 views,
   batch 2, 48/32/8, Adam) from seeded random weights, in bfloat16, in
   float32 and in bfloat16 with the fused view sum; a warm-up step and a
   few timed steps, in the train CLI's
   arithmetic (cuDNN's default TF32), with the launch counts read around
   them; ms per step split into forward, backward and optimizer, depth
   maps trained per second, peak memory; then one step's gradients
   against the same step on the plain ops and with the plain backward
   (see GRAD_COSINE_MIN and F32_COSINE_MIN), beside witnesses of the
   noise and planted kernel faults the gates must catch. The bf16 and
   float32 steps are also timed in turns with the other cost regulariser,
   whose step gradients are held to the default's
   (DENSE_GRAD_COSINE_MIN). Then the float32 step with ``remat`` and
   without on one model: ms per step and peak memory of each and in
   turns, the recompute's launches exactly, gradients, running statistics
   and their counts against the step without it (REMAT_COSINE_MIN).
6. Evaluation pipeline, through the port's CLIs on the card, with seeded
   weights whose probability volumes are peaked (PIPELINE_GAIN): (a) the
   nvJPEG codec against the committed libjpeg decodes
   (tests/data/torch_codec), its decode time and JPEG round trip at the
   DTU and TnT source sizes, and the PNG codec on 640x512 Paeth rows; (b)
   a 6-view synthetic scene at 1600x1200 through tools/infer.main at
   1152x864, 5 views, 48/32/8 of 192, float32 and bf16 at batch 1 (each
   PFM against the in-memory forward), float32 at batch 2 against batch 1
   in full float32, launches and nvJPEG calls counted; (c) tools/fuse.main
   (dynamic, normal, native) on (b)'s float32 outputs, dynamic and normal
   each view against the CPU fuser, native (the kernel csrc/native_fuse.cu,
   one launch per reference view, counted around the CLI's run) each view
   against its plain version on the card, bit for bit, the kernel timed
   alone from a CUDA graph and bounded per view; then
   a true-depth scan at 1152x864 fused on the card with dynamic (held
   against the CPU) and native (against the plain version), each scored by
   tools/eval_dtu.main (overall < 0.5); then (b)'s four output trees as
   four scans fused through tools/fuse.main (dynamic) at --num_workers 1
   and 4 (spawned processes), in turns (1, 4, 4, 1): four different PLYs,
   each scan's byte-identical across the runs, the "wrote" lines in
   testlist order, ms per scan and peak device memory at each count; (d) a 12-view scene at 1920x1080 in
   a TnT tree through infer (--dataset tnt, 11 views, inverse depth) and
   fuse (dynamic with thres_view 5, and native). The CPU fuser that (c)
   holds the card against reads the reference image with PIL and resizes
   with cv2, which the card's machine has (printed in phase 2).
7. The training side: (1) the DTU recipe (512x640, 5 views, 48/32/8,
   Adam) in two processes of batch 1 on the one card (``--ddp-child``;
   gloo with CUDA tensors, since NCCL refuses two ranks on one device),
   float32 and bf16, one warm-up and DDP_STEPS timed steps: disjoint
   shards, parameters bitwise equal across the processes, each process's
   launches per step as phase 5 counts them, and the parameter updates
   against one process at batch 2 on the same samples (see
   DDP_UPDATE_COSINE_MIN); (2) tools/train.py --distributed with NCCL at
   world size 1 (one card: nothing across cards is measured), with the
   CLI's default remat; (3) a seeded
   DTU training tree of 1600x1200 Paeth PNGs: every PNG decoded by the
   compiled unfilter and by numpy with equal bytes, ms per PNG of each,
   the loader's samples per second, and tools/train.py --dataset dtu's ms
   per step beside phase 5's model-only step (``--no_remat``, as phase 5
   steps); (4) a seeded 768x576 BlendedMVS tree through tools/train.py
   --dataset blended --loss bld --no_remat,
   its samples on the card (nvJPEG) against the CPU's (PIL) within the
   codec gate.
8. The mesh (``parallel/mesh.py``; ``--mesh-child``, processes sharing
   the one card through gloo): first K2, K6, K4, K7 and K8 against their
   plain versions on the shares of the source views and hypothesis slabs
   the meshes below give a process (K7/K8 on depth slabs of two, where
   the fused view sum stays on); then the DTU recipe (float32 with remat,
   the CLI's default; batch 1, Adam) at (1, 2, 1) and (1, 1, 2) in two
   processes and at (1, 2, 2) in four, and the DTU-eval forward in bf16
   and float32 at (1, 2, 2), each against one process on the card:
   update cosines per group (MESH_UPDATE_COSINE_MIN), depth, probability
   columns and confidence (MESH_AGREE_MIN), parameters bitwise equal
   across the processes, each process's launches per pass and the shapes
   its warp kernels received (its share), the collectives' bytes per kind
   and call site (``parallel/collectives.py``), ms per step and per map.
9. The pipeline's, the training side's and the mesh's figures, the two
   cost regularisation forms' and the remat step's, the kernel line
   (phase 3's kernels with their mesh shares and launches, and the native
   fuser's from phase 6), the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import subprocess
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# Peak operations per second by the kernel's arithmetic type, same source:
# dense bf16 on the tensor cores; float32 on the CUDA cores (non-tensor).
FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_FLOPS_PER_S = 495e12  # dense TF32 on the tensor cores, same source
H, W, V, B = 864, 1152, 5, 1
NDEPTHS = (48, 32, 8)
NUM_HYP = 192
REQUESTS = 3
TRAIN_H, TRAIN_W, TRAIN_B = 512, 640, 2  # the DTU recipe (reference scripts/train.sh)
TRAIN_STEPS = 3
# One step's parameter gradients held against two plain references:
# - the plain ops (plain forward and autograd): all-parameter cosine gated
#   at GRAD_COSINE_MIN. The two bf16 forwards differ by up to a bf16 step,
#   which moves stage-2/3 hypotheses through the argmax; per group this
#   reaches the noise floor (the plain step with its DCN outputs nudged by
#   one bf16 step agrees with it no better), so groups are printed only.
# - the same kernel forward with K3/K4's (and K8's) plain versions in the
#   backward: identical activations, so each group's cosine is gated at
#   BWD_COSINE_MIN, and a fault planted in K3, K4 or K8 must fall below it.
# Groups: FeatureNet (whose gradient passes through K3, and through K4 for
# the source views), its DCN offset convs alone, its stage-1 ARF head, its
# stage-2 and -3 ARF heads, and the rest (FMT, PixelwiseNet, CostRegNet),
# so a fault upstream of the warp cannot hide behind CostRegNet's larger
# gradients. With the fused view sum K4 runs at stage 1 and K8 at stages
# 2-3, and which stages dominate FeatureNet's gradient depends on the
# state the steps reached (K8 with dsrc zeroed read 0.939 there in one run
# and 0.99984 in another of the same seeds, on an NVIDIA H100 80GB HBM3 at
# 700 W). The stage-2/3 heads' gradient comes only
# through K8 on that path, and the stage-1 head's mostly through K4; a
# cosine is blind to the group's scale.
GRAD_GROUPS = {
    "feature_net": lambda n: n.startswith("feature."),
    "offset_convs": lambda n: "conv_offset_mask" in n,
    "arf_head_stage1": lambda n: n.startswith("feature.out1."),
    "arf_heads_stages_2_3": lambda n: n.startswith(("feature.out2.", "feature.out3.")),
    "rest": lambda n: not n.startswith("feature."),
}
GRAD_COSINE_MIN = 0.99
# Per activation dtype, set from the printed witness of the same noise,
# the plain step repeated (cuDNN's atomics): bf16 1 - 3e-5, float32
# 1 - 1e-8 at worst, on an NVIDIA H100 80GB HBM3 at a 700 W power limit.
BWD_COSINE_MIN = {"bfloat16": 0.999, "float32": 0.9999}
# float32 also gates each group against the plain step. There is no bf16
# noise floor, but the two forwards still differ by float32 rounding,
# which moves a few stage-2/3 hypotheses through the argmax: the kernels'
# worst group (FeatureNet) read 1 - 9e-6, 1 - 1.5e-4 and 1 - 5.8e-4 in
# three runs on that card, and the plain step with every DCN output nudged
# by one float32 step, the witness of that noise, 1 - 1.7e-4.
F32_COSINE_MIN = 0.995
# The fused path's stage-3 depth against the unfused bf16 kernels on the
# same weights and inputs: the two differ only in the float32 order of the
# weighted view sum before its bf16 cast, so nearly every pixel agrees.
FUSED_AGREE_MIN = 0.99
# ... and against the plain ops, as the unfused bf16 path reads (98.95% of
# stage-3 pixels within one interval on an NVIDIA H100 80GB HBM3 at 700 W).
FUSED_PLAIN_AGREE_MIN = 0.97


# The cost regulariser's other form (``dense_cost_reg``: the depth-as-
# channels CostRegNetDense or the 3-D CostRegNet) against the default's on
# the same weights and inputs, compared in full float32: stage-3 depth
# within one interval on DENSE_AGREE_MIN of the pixels, and as many
# stage-3 probability columns within DENSE_PROB_TOL of the column's spread
# (its largest less its smallest probability: random weights leave the
# columns nearly flat, so an absolute tolerance cannot tell a fault from
# rounding). In float32 the two differ in summation order only; in bf16
# each layer's output rounds to bf16 after other sums. The control is a
# planted fault, the dense form missing one band tap of one layer
# (``planted_band_fault``), which the gate must reject. Readings on an
# NVIDIA H100 80GB HBM3 at 700 W, sound bf16 / float32 / planted fault:
# depth 99.978% / 99.99999% / 99.81%; columns within 1e-2 of the spread
# 99.994% (bf16) against 27% planted, within 1e-3 99.9997% (float32)
# against 16%; the largest stage-3 probability difference 5.2e-6 (bf16)
# against 8.9e-6 planted.
DENSE_AGREE_MIN = {"float32": 0.999, "bfloat16": 0.999}
DENSE_PROB_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
# The two forms' step gradients from the same state, per GRAD_GROUPS: float32
# gates every group; bf16, whose forwards differ by rounding, the cosine over
# all parameters at GRAD_COSINE_MIN, as the kernels against the plain step.
DENSE_GRAD_COSINE_MIN = 0.9999
# ``remat`` recomputes the same forward: its step's gradients per group
# against the step without it, in full float32.
REMAT_COSINE_MIN = 0.9999


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


@contextlib.contextmanager
def configured(model, **changes):
    """The model with ``changes`` to its ModelConfig inside the block (the
    fields the forward reads at each call: fused_view_sum, remat,
    batch_views_jointly)."""
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, **changes)
    try:
        yield
    finally:
        model.cfg = cfg


@contextlib.contextmanager
def cost_reg_form(model, dense: bool):
    """The model's cost regularisers as ``CostRegNetDense`` (True) or
    ``CostRegNet`` inside the block. The two hold the same submodules and
    no other state, so an instance's class is its form."""
    from transmvsnet_tpu_torch.models.cost_reg import CostRegNet, CostRegNetDense

    regs = list(model.cost_regularization)
    classes = [type(m) for m in regs]
    for m in regs:
        m.__class__ = CostRegNetDense if dense else CostRegNet
    try:
        yield
    finally:
        for m, cls in zip(regs, classes):
            m.__class__ = cls


def view_sums(model) -> dict:
    return {"unfused": lambda: configured(model, fused_view_sum=False),
            "fused": lambda: configured(model, fused_view_sum=True)}


def cost_reg_forms(model) -> dict:
    return {"3d": lambda: cost_reg_form(model, False), "dense": lambda: cost_reg_form(model, True)}


def in_turns(fn, iters: int, variants: dict, rounds: int = 2) -> dict:
    """Milliseconds per call of ``fn`` by CUDA events under each of two
    variants (name: context factory) in turns (a, b, b, a, ...), so that
    both see the same clocks; each entry lists its rounds, and
    "<b>_over_<a>" is the ratio of their sums."""
    a, b = variants
    out = {a: [], b: []}
    for r in range(rounds):
        for name in ((a, b) if r % 2 == 0 else (b, a)):
            with variants[name]():
                out[name].append(cuda_ms(fn, iters=iters, warmup=1))
    out[f"{b}_over_{a}"] = sum(out[b]) / sum(out[a])
    return out


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: bytes over HBM bandwidth and
    operations over the peak for their type, the larger of the two."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FLOPS_PER_S[dtype]
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


def head_shapes(h: int, w: int) -> list[tuple[int, int, int, int]]:
    """(h, w, C_out, launches per pass) of the ARF heads' nine DCN layers
    for input images of h x w."""
    return [
        (h // 4, w // 4, 32, 3),
        (h // 2, w // 2, 32, 2),
        (h // 2, w // 2, 16, 1),
        (h, w, 32, 2),
        (h, w, 8, 1),
    ]


# (batch, height, width) of each path that runs the forward kernels.
PATHS = {"inference": (B, H, W), "train": (TRAIN_B, TRAIN_H, TRAIN_W)}


def suffix(dtype: torch.dtype) -> str:
    """Name suffix of a kernel's float32 instantiation and of the float32
    paths ("inference_f32", "train_f32")."""
    return "_f32" if dtype == torch.float32 else ""


def fwd_ms_by_offsets(rows: list, path: str) -> dict:
    """Per pass of ``path`` at each offset regime: each shape's time times
    its launches."""
    from transmvsnet_tpu_torch.tools.compare_dcn import FWD_REGIMES

    return {regime: sum(r["ms_by_offsets"][regime] * r["per_pass"] for r in rows if r["path"] == path)
            for regime in FWD_REGIMES}


def dcn_checks(dev, gen) -> dict:
    """K1 at every DCN shape of both paths, checked and timed at each offset
    regime of ``compare_dcn.FWD_REGIMES`` (zero; the inference paths'
    offset convs; these checks' earlier 0.12 / 0.5, whose time is the
    kernel line's "ms"). Beside it, as a yardstick the model does not run,
    the unfused bf16 route: cuDNN's offset conv in bf16, the split into
    offsets and masks, and K5's bf16 instantiation."""
    from transmvsnet_tpu_torch.ops.cuda.dcn import deform_conv2d
    from transmvsnet_tpu_torch.ops.dcn import offset_conv, split_offsets
    from transmvsnet_tpu_torch.tools.compare_dcn import FWD_REGIMES, forward_inputs

    C = 32
    rows = []
    for path, (b, ph, pw) in PATHS.items():
        for h, w, c_out, per_pass in head_shapes(ph, pw):
            N = b * V
            ms_at, unfused_at, res = {}, {}, {}
            for regime in FWD_REGIMES:
                fn, plain, args, _ = forward_inputs("dcn_fused", regime, gen, dev, N, h, w, c_out)
                with torch.no_grad():
                    got = fn(*args)
                    want = plain(*args)
                torch.cuda.synchronize()
                # Both round one float32 result to bfloat16: at most one bf16
                # step (2^-7 relative) apart, plus float32 summation-order noise.
                res[regime] = check_close(got, want, rtol=2.0**-7, atol_scale=1e-3)
                if res[regime]["n_outside"]:
                    raise AssertionError(f"dcn_fused disagrees at {(N, C, h, w, c_out)} {regime}: {res[regime]}")
                if not torch.equal(got, fn(*args)):
                    raise AssertionError(f"dcn_fused is not bitwise repeatable at {(N, C, h, w, c_out)} {regime}")
                del got, want
                x, k_off, b_off, weight, bias = args

                def unfused():
                    dy, dx, mask = split_offsets(offset_conv(x, k_off, b_off))
                    return deform_conv2d(x, dy.float(), dx.float(), mask.float(), weight, bias)

                with torch.no_grad():
                    ms_at[regime] = cuda_ms(lambda: fn(*args), iters=10)
                    unfused_at[regime] = cuda_ms(unfused, iters=10)
                    if regime == "checks":
                        plain_ms = cuda_ms(lambda: plain(*args), iters=2, warmup=1)
                del x, args
            pix = N * h * w
            nbytes = 2 * pix * C + 2 * pix * c_out + 4 * (27 * C * 9 + 27 + 9 * C * c_out + c_out)
            flops = 2 * pix * 9 * C * (27 + c_out + 4)
            bd = bound(nbytes, flops, torch.bfloat16)
            worst = max(res.values(), key=lambda r: r["max_abs_err"])
            rows.append(dict(path=path, shape=[N, C, h, w, c_out], per_pass=per_pass, ms=ms_at["checks"],
                             ms_by_offsets=ms_at, unfused_route_ms_by_offsets=unfused_at,
                             plain_ms=plain_ms, **bd, **worst))
            print(f"dcn_fused {path} {[N, C, h, w, c_out]}: ms by offsets "
                  + " / ".join(f"{r} {v:.4f}" for r, v in ms_at.items())
                  + " unfused route " + " / ".join(f"{v:.4f}" for v in unfused_at.values())
                  + f" plain_ms {plain_ms:.4f} bound_ms {bd['bound_ms']:.4f} ({bd['bound_by']}) "
                  f"max_abs_err {worst['max_abs_err']:.3g}", flush=True)
            torch.cuda.empty_cache()
    entry = summarise("dcn_fused", "transmvsnet_tpu_torch/csrc/dcn_fused.cu",
                      "transmvsnet_tpu/ops/pallas/dcn_onehot.py:610", rows, "inference")
    entry["ms_by_offsets"] = fwd_ms_by_offsets(rows, "inference")
    entry["unfused_route_ms_by_offsets"] = {
        regime: sum(r["unfused_route_ms_by_offsets"][regime] * r["per_pass"] for r in rows if r["path"] == "inference")
        for regime in entry["ms_by_offsets"]}
    print(f"dcn_fused per forward: ms by offsets {json.dumps(entry['ms_by_offsets'])}; the unfused bf16 "
          f"route (yardstick) {json.dumps(entry['unfused_route_ms_by_offsets'])}", flush=True)
    return entry


def dcn_fwd_bound(pix: int, C: int, c_out: int, dtype: torch.dtype) -> dict:
    """K5's least time, counted as ``dcn_bwd_bound`` counts K3's: the
    contraction (9 C C_out multiply-adds per pixel) on the tensor cores with
    split operands, three products each, over the TF32 (float32) or bf16
    peak; the bilinear samples (4 multiply-adds per (tap, channel)) over the
    CUDA cores' float32 peak; the bytes (x and the output in the activation
    type, the float32 offsets, mask, weight and bias, each once) over HBM
    bandwidth. The two kinds of units run side by side: the bound is the
    largest of the three."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = es * pix * (C + c_out) + 4 * pix * 27 + 4 * (9 * C * c_out + c_out)
    peak = TF32_FLOPS_PER_S if dtype == torch.float32 else FLOPS_PER_S[torch.bfloat16]
    t = {"bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
         "contraction_ms": 1e3 * 3 * 2 * pix * 9 * C * c_out / peak,
         "other_ms": 1e3 * 2 * pix * 9 * C * 4 / FLOPS_PER_S[torch.float32]}
    t["ops_ms"] = max(t["contraction_ms"], t["other_ms"])
    t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
    t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
    return t


def dcn_given_checks(dev, gen, dtype) -> dict:
    """K5 (DCN with given offsets and mask) in one activation type at every
    DCN shape of both paths, checked and timed at each offset regime of
    ``compare_dcn.FWD_REGIMES`` (zero and the inference paths' offsets and
    masks from those offset convs; random 1.5-px offsets and masks in
    (0, 1), the earlier regime and the kernel line's "ms"). float32 is the
    float32 paths' DCN (row 5); bf16 is row 4, which no model path runs
    (the bf16 layers take K1): its figures are for the nine DCN layers of a
    bf16 forward, 0 launches."""
    from transmvsnet_tpu_torch.tools.compare_dcn import FWD_REGIMES, forward_inputs

    name = "dcn_f32" if dtype == torch.float32 else "dcn_bf16"
    C = 32
    rows = []
    for path, (b, ph, pw) in PATHS.items():
        for h, w, c_out, per_pass in head_shapes(ph, pw):
            N = b * V
            ms_at, res = {}, {}
            for regime in FWD_REGIMES:
                fn, plain, args, _ = forward_inputs(name, regime, gen, dev, N, h, w, c_out)
                with torch.no_grad():
                    got = fn(*args)
                    want = plain(*args)
                torch.cuda.synchronize()
                if dtype == torch.bfloat16:
                    # Both round one float32 result to bfloat16: one bf16 step
                    # (2^-7 relative) apart at most, plus summation-order noise.
                    res[regime] = check_close(got, want, rtol=2.0**-7, atol_scale=1e-3)
                else:
                    # Float32 on both sides, summed in another order.
                    res[regime] = check_close(got, want, rtol=1e-4, atol_scale=1e-4)
                if res[regime]["n_outside"]:
                    raise AssertionError(f"{name} disagrees at {(N, C, h, w, c_out)} {regime}: {res[regime]}")
                if not torch.equal(got, fn(*args)):
                    raise AssertionError(f"{name} is not bitwise repeatable at {(N, C, h, w, c_out)} {regime}")
                del got, want
                with torch.no_grad():
                    ms_at[regime] = cuda_ms(lambda: fn(*args), iters=10)
                    if regime == "checks":
                        plain_ms = cuda_ms(lambda: plain(*args), iters=2, warmup=1)
                del args
            bd = dcn_fwd_bound(N * h * w, C, c_out, dtype)
            worst = max(res.values(), key=lambda r: r["max_abs_err"])
            rows.append(dict(path=path + suffix(dtype), shape=[N, C, h, w, c_out], per_pass=per_pass,
                             ms=ms_at["checks"], ms_by_offsets=ms_at, plain_ms=plain_ms, **bd, **worst))
            print(f"{name} {path} {[N, C, h, w, c_out]}: ms by offsets "
                  + " / ".join(f"{r} {v:.4f}" for r, v in ms_at.items())
                  + f" plain_ms {plain_ms:.4f} bound_ms {bd['bound_ms']:.4f} ({bd['bound_by']}: bytes "
                  f"{bd['bytes_ms']:.4f}, contraction {bd['contraction_ms']:.4f}, samples {bd['other_ms']:.4f}) "
                  f"max_abs_err {worst['max_abs_err']:.3g}", flush=True)
            torch.cuda.empty_cache()
    replaces = ("transmvsnet_tpu/ops/pallas/dcn_rowsweep.py:219" if dtype == torch.float32
                else "transmvsnet_tpu/ops/pallas/dcn_onehot.py:716")
    entry = summarise(name, "transmvsnet_tpu_torch/csrc/dcn.cu", replaces, rows, "inference" + suffix(dtype))
    entry["ms_by_offsets"] = fwd_ms_by_offsets(rows, "inference" + suffix(dtype))
    print(f"{name} per forward: ms by offsets {json.dumps(entry['ms_by_offsets'])} "
          f"bound {entry['bound_ms']:.4f} ({entry['bound_by']})", flush=True)
    return entry


# (stage, C, D) of the three plane sweeps.
SWEEPS = [("stage1", 32, NDEPTHS[0]), ("stage2", 16, NDEPTHS[1]), ("stage3", 8, NDEPTHS[2])]


def warp_checks(dev, gen, dtype) -> dict:
    """K2 (bf16 features) or K6 (float32 features) at every plane sweep of
    both paths. "ms" is the device time of a call's two launches (the
    channels-last copy and the body) alone, replayed from a CUDA graph
    (``compare_dcn.kernel_ms``): the wrapper's host time per call, which
    exceeds it, is "call_ms"."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
        warp_correlate,
        warp_correlate_plain,
    )
    from transmvsnet_tpu_torch.tools.compare_dcn import kernel_ms, sweep_inputs, warp_fwd_launch

    name = "warp_correlate" + suffix(dtype)
    S = V - 1
    rows = []
    for path, (b, ph, pw) in PATHS.items():
        for i, (stage, C, D) in enumerate(SWEEPS):
            args = sweep_inputs(gen, dev, b, ph, pw, i, stage, C, D, dtype)
            h, w = args[0].shape[-2:]
            got = warp_correlate(*args)
            want = warp_correlate_plain(*args)
            torch.cuda.synchronize()
            # Same float32 arithmetic up to summation order and fused
            # multiply-adds in the projection (~1e-5 px of sample position).
            res = check_close(got, want, rtol=1e-3, atol_scale=1e-3)
            if res["n_outside"]:
                raise AssertionError(f"{name} disagrees at {path} {stage}: {res}")
            # No atomics, sums in a fixed order.
            if not torch.equal(got, warp_correlate(*args)):
                raise AssertionError(f"{name} is not bitwise repeatable at {path} {stage}")
            valid = (want != 0).float().mean().item()
            del got, want
            ms = kernel_ms(warp_fwd_launch(name, args), iters=10, replays=5)
            call_ms = cuda_ms(lambda: warp_correlate(*args), iters=50, warmup=5)
            plain_ms = cuda_ms(lambda: warp_correlate_plain(*args), iters=2, warmup=1)
            n_out = b * S * D * h * w
            es = args[0].element_size()
            nbytes = es * (b * S + b) * C * h * w + 4 * b * D * h * w + 4 * n_out + 4 * b * S * 12
            # Projection (~12) per output; bilinear sample and product
            # (~10 C) only where the sample is valid, as this run's data
            # needs.
            flops = n_out * (12 + valid * 10 * C)
            bd = bound(nbytes, flops, dtype)
            rows.append(dict(path=path + suffix(dtype), shape=[b * S, C, D, h, w], per_pass=1, ms=ms,
                             call_ms=call_ms, plain_ms=plain_ms, nonzero_share=valid, **bd, **res))
            print(f"{name} {path} {[b * S, C, D, h, w]}: ms {ms:.4f} (per wrapper call {call_ms:.4f}) "
                  f"plain_ms {plain_ms:.4f} "
                  f"bound_ms {bd['bound_ms']:.4f} ({bd['bound_by']}) "
                  f"max_abs_err {res['max_abs_err']:.3g} nonzero {valid:.3f}", flush=True)
            del args
            torch.cuda.empty_cache()
    replaces = ("transmvsnet_tpu/ops/pallas/warp_rowsweep.py:230" if dtype == torch.float32
                else "transmvsnet_tpu/ops/pallas/warp_onehot.py:291")
    entry = summarise(name, "transmvsnet_tpu_torch/csrc/warp_correlate.cu", replaces, rows,
                      "inference" + suffix(dtype))
    entry["call_ms"] = sum(r["call_ms"] for r in rows if r["path"] == entry["main_path"])
    return entry


def check_all(got, want, rtol, atol_scale, what) -> dict:
    """``check_close`` over a tuple of outputs; raises if any is outside."""
    results = [check_close(g, w, rtol, atol_scale) for g, w in zip(got, want)]
    bad = {i: r for i, r in enumerate(results) if r["n_outside"]}
    if bad:
        raise AssertionError(f"{what} disagrees with its plain version: {bad}")
    return {"max_abs_err": max(r["max_abs_err"] for r in results),
            "scale": max(r["scale"] for r in results), "tolerance": results[0]["tolerance"]}


# K3's offset regimes, in pixels (the standard deviation of random offsets):
# zero (the reference's initial state: every tap on an integer), 2 px (some
# taps off the image, a few corners beyond the kernel's dx window) and 6 px
# (corners often beyond the window's 2-px halo: its global branch). Each is
# checked; the time at 2 px is the kernel line's "ms", as in earlier runs.
DCN_BWD_OFFSETS = (0.0, 2.0, 6.0)


def dcn_bwd_bound(pix: int, C: int, c_out: int, x_bytes: int) -> dict:
    """K3's least time, counted alike for both instantiations (both compute
    in float32 from the activations): the two contractions (q = W^T g and
    dw, 2 * 9 C C_out multiply-adds per pixel) on the tensor cores in
    3xTF32, three TF32 products per float32 product, over the TF32 peak;
    the sampling, the offset and mask sums and the scatter (~20 float32
    operations per (tap, channel)) over the CUDA cores' float32 peak; the
    bytes (each input read once, each output written once) over HBM
    bandwidth. The two kinds of units run side by side: the bound is the
    largest of the three."""
    nbytes = (x_bytes * pix * C + 4 * pix * (3 * 9 + c_out)   # x, dy/dx/mask, g
              + 4 * 9 * C * c_out                            # w
              + 4 * pix * (C + 3 * 9) + 4 * 9 * C * c_out)   # dx, ddy/ddx/dm, dw
    t = {"bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
         "contraction_ms": 1e3 * 3 * pix * 4 * 9 * C * c_out / TF32_FLOPS_PER_S,
         "other_ms": 1e3 * pix * 9 * C * 20 / FLOPS_PER_S[torch.float32]}
    t["ops_ms"] = max(t["contraction_ms"], t["other_ms"])
    t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
    t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
    return t


def dcn_bwd_checks(dev, gen, dtype) -> dict:
    """K3's instantiation for ``dtype`` at every DCN shape of the training
    path, checked at each of DCN_BWD_OFFSETS and timed at each."""
    from transmvsnet_tpu_torch.ops.cuda.dcn_bwd import dcn_bwd, dcn_bwd_plain

    name = "dcn_bwd" + suffix(dtype)
    # The ARF heads' DCN layers at the training resolution, batch 2 x 5 views.
    C, N = 32, TRAIN_B * V
    rows = []
    for h, w, c_out, per_step in head_shapes(TRAIN_H, TRAIN_W):
        def rnd(*shape, s=1.0):
            return (torch.randn(*shape, generator=gen) * s).to(dev)

        x = rnd(N, C, h, w).to(dtype)
        mask = torch.rand(N, 9, h, w, generator=gen).to(dev)
        weight = rnd(9, C, c_out, s=0.1)
        g = rnd(N, c_out, h, w)
        res, ms_at = {}, {}
        for off_scale in DCN_BWD_OFFSETS:
            dy, dx = rnd(N, 9, h, w, s=off_scale), rnd(N, 9, h, w, s=off_scale)
            args = (x, dy, dx, mask, weight, g)
            got = dcn_bwd(*args)
            want = dcn_bwd_plain(*args)
            torch.cuda.synchronize()
            # Same float32 arithmetic on the same sample positions; sums
            # (and the atomics into dx and dw) in another order.
            res[off_scale] = check_all(got, want, 1e-3, 1e-4, f"{name} {(N, C, h, w, c_out)} offsets {off_scale}")
            if off_scale == 0.0 and not (got[1].abs().max() > 0 and got[2].abs().max() > 0):
                raise AssertionError(f"{name}: zero offsets got no offset gradient (two-tap rule)")
            del got, want
            ms_at[off_scale] = cuda_ms(lambda: dcn_bwd(*args), iters=5, warmup=1)
            if off_scale == 2.0:
                plain_ms = cuda_ms(lambda: dcn_bwd_plain(*args), iters=1, warmup=1)
        worst = max(res.values(), key=lambda r: r["max_abs_err"])
        bd = dcn_bwd_bound(N * h * w, C, c_out, x.element_size())
        rows.append(dict(path="train" + suffix(dtype), shape=[N, C, h, w, c_out], per_pass=per_step,
                         ms=ms_at[2.0], ms_zero_offsets=ms_at[0.0], ms_large_offsets=ms_at[6.0],
                         plain_ms=plain_ms, **bd, **worst))
        print(f"{name} {[N, C, h, w, c_out]}: ms at offsets 0 / 2 / 6 px "
              f"{ms_at[0.0]:.4f} / {ms_at[2.0]:.4f} / {ms_at[6.0]:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bd['bound_ms']:.4f} ({bd['bound_by']}: bytes {bd['bytes_ms']:.4f}, "
              f"contractions {bd['contraction_ms']:.4f}, other {bd['other_ms']:.4f}) "
              f"max_abs_err {worst['max_abs_err']:.3g} at scale {worst['scale']:.3g}", flush=True)
        del x, mask, weight, g, args
        torch.cuda.empty_cache()
    entry = summarise(name, "transmvsnet_tpu_torch/csrc/dcn_bwd.cu",
                      "transmvsnet_tpu/ops/pallas/dcn_bwd.py:410", rows, "train" + suffix(dtype))
    # Per step at each offset regime (each shape's time times its launches).
    entry["ms_by_offsets"] = {f"{off:g}px": sum(r[key] * r["per_pass"] for r in rows)
                              for off, key in zip(DCN_BWD_OFFSETS,
                                                  ("ms_zero_offsets", "ms", "ms_large_offsets"))}
    print(f"{name} per step: ms by offsets {json.dumps(entry['ms_by_offsets'])} "
          f"bound {entry['bound_ms']:.4f} ({entry['bound_by']})", flush=True)
    return entry


def warp_bwd_checks(dev, gen, dtype) -> dict:
    """K4's instantiation for ``dtype`` at every plane sweep of the training
    path."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import (
        warp_correlate_bwd,
        warp_correlate_bwd_plain,
    )
    from transmvsnet_tpu_torch.tools.compare_dcn import sweep_inputs, valid_share

    name = "warp_correlate_bwd" + suffix(dtype)
    Bt, S = TRAIN_B, V - 1
    rows = []
    for i, (stage, C, D) in enumerate(SWEEPS):
        fwd_args = sweep_inputs(gen, dev, Bt, TRAIN_H, TRAIN_W, i, stage, C, D, dtype)
        h, w = fwd_args[0].shape[-2:]
        g = torch.randn(Bt, S, D, h, w, generator=gen).to(dev)
        args = (*fwd_args, g)
        got = warp_correlate_bwd(*args)
        want = warp_correlate_bwd_plain(*args)
        torch.cuda.synchronize()
        # As K2: float32 arithmetic up to summation order (atomics) and
        # fused multiply-adds in the projection (~1e-5 px of position).
        res = check_all(got, want, 1e-3, 1e-3, f"{name} at {stage}")
        del got, want
        ms = cuda_ms(lambda: warp_correlate_bwd(*args), iters=10, warmup=2)
        plain_ms = cuda_ms(lambda: warp_correlate_bwd_plain(*args), iters=1, warmup=1)
        valid = valid_share(fwd_args)
        n_out = Bt * S * D * h * w
        es = fwd_args[0].element_size()
        nbytes = (es * (Bt * S + Bt) * C * h * w + 4 * Bt * D * h * w + 4 * n_out  # src, ref, depth, g
                  + 4 * (Bt * S + Bt) * C * h * w + 4 * Bt * S * 12)               # dsrc, dref, rel
        # Projection (~12) per (view, hypothesis, pixel); where the sample
        # is valid (as this run's data needs), per channel the bilinear
        # sample (~8), the dref product (2) and the scatter (~8).
        flops = n_out * (12 + valid * 18 * C)
        bd = bound(nbytes, flops, dtype)
        rows.append(dict(path="train" + suffix(dtype), shape=[Bt * S, C, D, h, w], per_pass=1, ms=ms,
                         plain_ms=plain_ms, nonzero_share=valid, **bd, **res))
        print(f"{name} {[Bt * S, C, D, h, w]}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bd['bound_ms']:.4f} ({bd['bound_by']}) "
              f"max_abs_err {res['max_abs_err']:.3g} at scale {res['scale']:.3g} nonzero {valid:.3f}",
              flush=True)
        del fwd_args, g, args
        torch.cuda.empty_cache()
    return summarise(name, "transmvsnet_tpu_torch/csrc/warp_correlate_bwd.cu",
                     "transmvsnet_tpu/ops/pallas/warp_bwd.py:504", rows, "train" + suffix(dtype))


# (stage index, stage, C, D) of the two plane sweeps that take view weights.
WSUM_SWEEPS = [(i, *sweep) for i, sweep in enumerate(SWEEPS)][1:]


def wsum_inputs(gen, dev, b, ph, pw, i, stage, C, D):
    """``sweep_inputs`` in bf16 plus view weights in [0, 1)."""
    from transmvsnet_tpu_torch.tools.compare_dcn import sweep_inputs

    args = sweep_inputs(gen, dev, b, ph, pw, i, stage, C, D, torch.bfloat16)
    h, w = args[0].shape[-2:]
    vw = torch.rand(b, V - 1, h, w, generator=gen).to(dev)
    return (*args, vw)


def wsum_checks(dev, gen) -> dict:
    """K7 (the view-weighted sum, bf16) at stages 2-3 of both paths; "ms"
    (the channels-last copy and the body) and "call_ms" as
    ``warp_checks``'."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
        warp_correlate_wsum,
        warp_correlate_wsum_plain,
    )
    from transmvsnet_tpu_torch.tools.compare_dcn import kernel_ms, valid_share, warp_fwd_launch

    S = V - 1
    rows = []
    for path, (b, ph, pw) in PATHS.items():
        for i, stage, C, D in WSUM_SWEEPS:
            args = wsum_inputs(gen, dev, b, ph, pw, i, stage, C, D)
            h, w = args[0].shape[-2:]
            got = warp_correlate_wsum(*args)
            want = warp_correlate_wsum_plain(*args)
            torch.cuda.synchronize()
            # As K2: float32 arithmetic up to summation order and fused
            # multiply-adds in the projection (~1e-5 px of sample position).
            res = check_close(got, want, rtol=1e-3, atol_scale=1e-3)
            if res["n_outside"]:
                raise AssertionError(f"warp_correlate_wsum disagrees at {path} {stage}: {res}")
            # No atomics, the views summed in a fixed order.
            if not torch.equal(got, warp_correlate_wsum(*args)):
                raise AssertionError(f"warp_correlate_wsum is not bitwise repeatable at {path} {stage}")
            del got, want
            valid = valid_share(args)
            ms = kernel_ms(warp_fwd_launch("warp_correlate_wsum", args), iters=10, replays=5)
            call_ms = cuda_ms(lambda: warp_correlate_wsum(*args), iters=50, warmup=5)
            plain_ms = cuda_ms(lambda: warp_correlate_wsum_plain(*args), iters=2, warmup=1)
            n_samples = b * S * D * h * w
            # bf16 src and ref; float32 depth, view weights, output, rel.
            nbytes = (2 * (b * S + b) * C * h * w + 4 * b * D * h * w + 4 * b * S * h * w
                      + 4 * b * D * h * w + 4 * b * S * 12)
            # Per sample the projection (~12) and the weighted sum (2);
            # bilinear sample and product (~10 C) only where it is valid.
            flops = n_samples * (14 + valid * 10 * C)
            bd = bound(nbytes, flops, torch.bfloat16)
            rows.append(dict(path=path + "_fused", shape=[b, S, C, D, h, w], per_pass=1, ms=ms,
                             call_ms=call_ms, plain_ms=plain_ms, nonzero_share=valid, **bd, **res))
            print(f"warp_correlate_wsum {path} {[b, S, C, D, h, w]}: ms {ms:.4f} (per wrapper call "
                  f"{call_ms:.4f}) plain_ms {plain_ms:.4f} "
                  f"bound_ms {bd['bound_ms']:.4f} ({bd['bound_by']}) "
                  f"max_abs_err {res['max_abs_err']:.3g} valid {valid:.3f}", flush=True)
            del args
            torch.cuda.empty_cache()
    entry = summarise("warp_correlate_wsum", "transmvsnet_tpu_torch/csrc/warp_correlate.cu",
                      "transmvsnet_tpu/ops/pallas/warp_onehot.py:442", rows, "inference_fused")
    entry["call_ms"] = sum(r["call_ms"] for r in rows if r["path"] == entry["main_path"])
    return entry


def wsum_bwd_checks(dev, gen) -> dict:
    """K8 (dsrc and dref of the view-weighted sum, bf16) at stages 2-3 of
    the training path, in both instantiations: without dvw, what the fused
    step runs (its view weights need no gradient), whose time is the kernel
    line's "ms"; and with dvw."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import (
        warp_correlate_wsum_bwd,
        warp_correlate_wsum_bwd_plain,
    )
    from transmvsnet_tpu_torch.tools.compare_dcn import valid_share

    Bt, S = TRAIN_B, V - 1
    rows = []
    for i, stage, C, D in WSUM_SWEEPS:
        fwd_args = wsum_inputs(gen, dev, Bt, TRAIN_H, TRAIN_W, i, stage, C, D)
        h, w = fwd_args[0].shape[-2:]
        g = torch.randn(Bt, D, h, w, generator=gen).to(dev)
        args = (*fwd_args, g)
        res, ms, plain_ms = {}, {}, {}
        for need_dvw in (False, True):
            got = warp_correlate_wsum_bwd(*args, need_dvw=need_dvw)
            want = warp_correlate_wsum_bwd_plain(*args, need_dvw=need_dvw)
            torch.cuda.synchronize()
            if (got[2] is None) == need_dvw:
                raise AssertionError(f"warp_correlate_wsum_bwd returned dvw against need_dvw={need_dvw}")
            # As K4: float32 arithmetic up to summation order (atomics) and
            # fused multiply-adds in the projection (~1e-5 px of position).
            res[need_dvw] = check_all(got[: 2 + need_dvw], want[: 2 + need_dvw], 1e-3, 1e-3,
                                      f"warp_correlate_wsum_bwd (need_dvw={need_dvw}) at {stage}")
            del got, want
            ms[need_dvw] = cuda_ms(lambda: warp_correlate_wsum_bwd(*args, need_dvw=need_dvw), iters=10, warmup=2)
            plain_ms[need_dvw] = cuda_ms(lambda: warp_correlate_wsum_bwd_plain(*args, need_dvw=need_dvw),
                                         iters=1, warmup=1)
        valid = valid_share(fwd_args)
        n_samples = Bt * S * D * h * w
        nbytes = (2 * (Bt * S + Bt) * C * h * w + 4 * Bt * D * h * w      # src, ref, depth
                  + 4 * Bt * S * h * w + 4 * Bt * D * h * w + 4 * Bt * S * 12  # vw, g, rel
                  + 4 * (Bt * S + Bt) * C * h * w)                          # dsrc, dref
        # Projection (~12) per sample; where it is valid, per channel the
        # bilinear sample (~8), the dref product (2) and the scatter (~8);
        # with dvw also its product (2) and its write.
        bd = bound(nbytes, n_samples * (12 + valid * 18 * C), torch.bfloat16)
        bd_dvw = bound(nbytes + 4 * Bt * S * h * w, n_samples * (12 + valid * 20 * C), torch.bfloat16)
        worst = max(res.values(), key=lambda r: r["max_abs_err"])
        rows.append(dict(path="train_fused", shape=[Bt, S, C, D, h, w], per_pass=1, ms=ms[False],
                         plain_ms=plain_ms[False], ms_with_dvw=ms[True], plain_ms_with_dvw=plain_ms[True],
                         bound_ms_with_dvw=bd_dvw["bound_ms"], nonzero_share=valid, **bd, **worst))
        print(f"warp_correlate_wsum_bwd {[Bt, S, C, D, h, w]}: ms without / with dvw {ms[False]:.4f} / "
              f"{ms[True]:.4f} plain_ms {plain_ms[False]:.4f} / {plain_ms[True]:.4f} bound_ms "
              f"{bd['bound_ms']:.4f} / {bd_dvw['bound_ms']:.4f} ({bd['bound_by']}) "
              f"max_abs_err {worst['max_abs_err']:.3g} at scale {worst['scale']:.3g} valid {valid:.3f}",
              flush=True)
        del fwd_args, g, args
        torch.cuda.empty_cache()
    entry = summarise("warp_correlate_wsum_bwd", "transmvsnet_tpu_torch/csrc/warp_correlate_bwd.cu",
                      "transmvsnet_tpu/ops/pallas/warp_bwd.py:469", rows, "train_fused")
    entry["with_dvw"] = {key: sum(r[key] for r in rows)
                         for key in ("ms_with_dvw", "plain_ms_with_dvw", "bound_ms_with_dvw")}
    return entry


def summarise(name, source, replaces, rows, main) -> dict:
    """One kernel instantiation's entry: times and bound per pass of each
    path that runs it (a forward for inference, a step for training: each
    shape's figure times its launches per pass), headed by the ``main``
    path's; worst error over all shapes."""
    def per_pass(path, key):
        return sum(r[key] * r["per_pass"] for r in rows if r["path"] == path)

    by_path = {
        path: {key: per_pass(path, key) for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
        for path in dict.fromkeys(r["path"] for r in rows)
    }
    head = by_path[main]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes" if head["bytes_ms"] >= head["ops_ms"] else "operations",
        "library_ms": None, "main_path": main, "by_path": by_path, "shapes": rows,
    }


def kernel_counters() -> dict:
    """Each kernel instantiation's launch counter, as (wrapper, attribute):
    a wrapper's ``launches`` counts its bf16 instantiation, ``launches_f32``
    its float32 one."""
    from transmvsnet_tpu_torch.ops.cuda.dcn import deform_conv2d
    from transmvsnet_tpu_torch.ops.cuda.dcn_bwd import dcn_bwd
    from transmvsnet_tpu_torch.ops.cuda.dcn_fused import dcn_fused
    from transmvsnet_tpu_torch.ops.cuda.native_fuse import native_fuse
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import warp_correlate, warp_correlate_wsum
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import (
        warp_correlate_bwd,
        warp_correlate_wsum_bwd,
    )

    return {
        "dcn_fused": (dcn_fused, "launches"),
        "warp_correlate": (warp_correlate, "launches"),
        "dcn_bwd": (dcn_bwd, "launches"),
        "warp_correlate_bwd": (warp_correlate_bwd, "launches"),
        "dcn_f32": (deform_conv2d, "launches_f32"),
        "dcn_bf16": (deform_conv2d, "launches"),
        "warp_correlate_f32": (warp_correlate, "launches_f32"),
        "dcn_bwd_f32": (dcn_bwd, "launches_f32"),
        "warp_correlate_bwd_f32": (warp_correlate_bwd, "launches_f32"),
        "warp_correlate_wsum": (warp_correlate_wsum, "launches"),
        "warp_correlate_wsum_bwd": (warp_correlate_wsum_bwd, "launches"),
        "native_fuse": (native_fuse, "launches"),
    }


def reset_launches() -> None:
    for f, attr in kernel_counters().values():
        setattr(f, attr, 0)


def read_launches() -> dict:
    return {name: getattr(f, attr) for name, (f, attr) in kernel_counters().items()}


def expect_launches(launches: dict, per_pass: dict, passes: int, what: str) -> None:
    """Raise unless each kernel in ``per_pass`` launched exactly that many
    times per pass and every other kernel not at all."""
    want = {name: per_pass.get(name, 0) * passes for name in launches}
    if launches != want:
        raise AssertionError(f"{what}: expected {per_pass} launches per pass over {passes}: {launches}")


# Kernel launches per forward, and per training step, of each path.
FORWARD_LAUNCHES = {
    "inference": {"dcn_fused": 9, "warp_correlate": 3},
    "inference_f32": {"dcn_f32": 9, "warp_correlate_f32": 3},
    "inference_fused": {"dcn_fused": 9, "warp_correlate": 1, "warp_correlate_wsum": 2},
    # bf16 with FeatureNet run once per view (batch_views_jointly=False).
    "inference_per_view": {"dcn_fused": 9 * V, "warp_correlate": 3},
}
STEP_LAUNCHES = {
    "train": {"dcn_fused": 9, "warp_correlate": 3, "dcn_bwd": 9, "warp_correlate_bwd": 3},
    "train_f32": {"dcn_f32": 9, "warp_correlate_f32": 3, "dcn_bwd_f32": 9, "warp_correlate_bwd_f32": 3},
    "train_fused": {"dcn_fused": 9, "warp_correlate": 1, "warp_correlate_wsum": 2, "dcn_bwd": 9,
                    "warp_correlate_bwd": 1, "warp_correlate_wsum_bwd": 2},
    # float32 with remat: the backward's recompute of FeatureNet runs K5
    # again for each of its 9 DCN layers (the last one's Function saves
    # its tensors after its kernel ran, where torch.utils.checkpoint's
    # early stop then ends the recompute). The warp is outside every
    # rematerialised module, as in the JAX package.
    "train_f32_remat": {"dcn_f32": 9 + 9, "warp_correlate_f32": 3, "dcn_bwd_f32": 9, "warp_correlate_bwd_f32": 3},
}
# (activation dtype, fused view sum) of each path.
PATH_CONFIGS = {"": ("bfloat16", False), "_f32": ("float32", False), "_fused": ("bfloat16", True)}


def cudnn_default_arithmetic():
    """PyTorch's default arithmetic, in which cuDNN may use TF32: what the
    CLIs run. The rest of this script runs in full float32."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=True)


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


def main_path(dev, sfx: str) -> dict:
    """The inference path "inference" + ``sfx`` (see PATH_CONFIGS). The bf16
    requests run in full float32 arithmetic elsewhere (TF32 off); the
    float32 ones in PyTorch's default arithmetic, as the inference CLI runs
    them. Kernels and plain ops are compared in full float32 either way;
    the fused path also against the unfused bf16 kernels."""
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.example import DEPTH_MAX, DEPTH_MIN, example_inputs
    from transmvsnet_tpu_torch.models.feature_net import DCN
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet

    dtype_name, fused = PATH_CONFIGS[sfx]
    f32 = dtype_name == "float32"
    what = f"inference path ({dtype_name}{', fused view sum' if fused else ''})"
    gen = torch.Generator().manual_seed(0)
    cfg = ModelConfig(ndepths=NDEPTHS, compute_dtype=dtype_name, fused_view_sum=fused)
    what += f", {'dense' if cfg.dense_cost_reg else '3-D'} cost regularisation"
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

    with cudnn_default_arithmetic() if f32 else contextlib.nullcontext():
        forward()  # warm-up: cuDNN plans and the allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REQUESTS):
            out = forward()
        end.record()
        torch.cuda.synchronize()
        launches = read_launches()
        ms_per_map = start.elapsed_time(end) / REQUESTS
        peak = torch.cuda.max_memory_allocated()
        print(f"{what}: {REQUESTS} requests, launches {launches}", flush=True)
        expect_launches(launches, FORWARD_LAUNCHES["inference" + sfx], REQUESTS, what)
        breakdown = module_breakdown(model, forward)
        turns = {"ms_per_depth_map_in_turns": in_turns(forward, REQUESTS, view_sums(model))} if fused else {}
        if not fused:
            # The cost regulariser's two forms in turns, and each one's
            # forward by part.
            turns = {"ms_per_depth_map_in_turns_by_cost_reg": in_turns(forward, REQUESTS, cost_reg_forms(model))}
            turns["ms_by_part_by_cost_reg"] = {}
            for form, context in cost_reg_forms(model).items():
                with context():
                    turns["ms_by_part_by_cost_reg"][form] = module_breakdown(model, forward)

    out = forward()  # in full float32 arithmetic, as the plain path below
    for s in ("stage1", "stage2", "stage3"):
        d, dvals = out[s]["depth"], out[s]["depth_values"]
        conf = out[s]["photo_confidence"]
        if not torch.isfinite(d).all() or not torch.isfinite(out[s]["prob_volume"]).all():
            raise AssertionError(f"{what} {s}: non-finite output")
        lo, hi = dvals.amin(dim=1), dvals.amax(dim=1)
        if not ((d >= lo) & (d <= hi)).all():
            raise AssertionError(f"{what} {s}: depth outside its hypothesis range")
        if not ((conf >= 0) & (conf <= 1)).all():
            raise AssertionError(f"{what} {s}: confidence outside [0, 1]")
    if tuple(out["depth"].shape) != (B, H, W):
        raise AssertionError(f"{what}: depth shape {tuple(out['depth'].shape)}")

    model.use_plain_ops(True)
    forward()
    plain_ms = cuda_ms(forward, iters=1, warmup=0)
    plain = forward()
    model.use_plain_ops(False)
    interval = cfg.depth_interval_ratios[2] * (DEPTH_MAX - DEPTH_MIN) / NUM_HYP

    def within_interval(other):
        return ((out["depth"] - other["depth"]).abs() <= interval).float().mean().item()

    def max_dprob(other):
        return {s: (out[s]["prob_volume"] - other[s]["prob_volume"]).abs().max().item()
                for s in ("stage1", "stage2", "stage3")}

    agree, dprob = within_interval(plain), max_dprob(plain)
    vs_unfused = {}
    if not fused:
        vs_unfused = {**turns, "other_cost_reg": cost_reg_agreement(model, forward, out, interval, what)}
    if sfx == "":
        vs_unfused["per_view_features"] = per_view_forward(model, forward, within_interval, what)
    if fused:
        with configured(model, fused_view_sum=False):
            unfused = forward()
        vs_unfused = {"stage3_depth_within_one_interval_of_unfused": within_interval(unfused),
                      "max_abs_dprob_vs_unfused": max_dprob(unfused), **turns}
    result = {
        "dtype": dtype_name,
        "fused_view_sum": fused,
        "depth_maps_per_s": 1e3 / ms_per_map,
        "ms_per_depth_map": ms_per_map,
        "plain_ops_ms_per_depth_map": plain_ms,
        "peak_memory_bytes": peak,
        "launches": launches,
        "ms_by_part": breakdown,
        "stage3_depth_within_one_interval_of_plain": agree,
        "max_abs_dprob_vs_plain": dprob,
        **vs_unfused,
    }
    print(f"{what}: " + json.dumps(result), flush=True)
    if fused:
        if not vs_unfused["stage3_depth_within_one_interval_of_unfused"] >= FUSED_AGREE_MIN:
            raise AssertionError(f"{what}: stage-3 depth agrees with the unfused kernels below "
                                 f"{FUSED_AGREE_MIN}: {vs_unfused}")
        if not agree >= FUSED_PLAIN_AGREE_MIN:
            raise AssertionError(f"{what}: stage-3 depth agrees with the plain ops below "
                                 f"{FUSED_PLAIN_AGREE_MIN}: {agree}")
    return result


def planted_band_fault(model):
    """Stage 3's dense regulariser with its last "up" layer (conv11, D_in =
    NDEPTHS[2] // 2 there, and only there) missing the band's edge tap into
    the last output depth: a wrong edge tap in one layer, the control
    DENSE_AGREE_MIN's gate must reject."""
    from transmvsnet_tpu_torch.models import cost_reg

    band, d_in = cost_reg._depth_band, NDEPTHS[2] // 2

    def faulty(D_in, mode, device):
        S = band(D_in, mode, device)
        if mode == "up" and D_in == d_in:
            S = S.clone()
            S[2, D_in - 1, 2 * D_in - 1] = 0.0
        return S

    def install(*_):
        cost_reg._depth_band = faulty

    def restore(*_):
        cost_reg._depth_band = band

    @contextlib.contextmanager
    def planted():
        reg = model.cost_regularization[2]
        handles = [reg.register_forward_pre_hook(install), reg.register_forward_hook(restore)]
        try:
            yield
        finally:
            restore()
            for h in handles:
                h.remove()

    return planted()


def form_agreement(a: dict, b: dict, interval: float, dtype_name: str) -> dict:
    """Two forwards' stage-3 depth within one interval, their stage-3
    probability columns within DENSE_PROB_TOL of ``b``'s column spread (and,
    as readings, within other fractions of it), and each stage's largest
    probability difference."""
    dprob = (a["stage3"]["prob_volume"] - b["stage3"]["prob_volume"]).abs().amax(dim=1)
    ref = b["stage3"]["prob_volume"]
    spread = ref.amax(dim=1) - ref.amin(dim=1)
    return {
        "stage3_depth_within_one_interval": ((a["depth"] - b["depth"]).abs() <= interval).float().mean().item(),
        "stage3_prob_columns_within_tol": (dprob <= DENSE_PROB_TOL[dtype_name] * spread).float().mean().item(),
        "stage3_prob_columns_within_of_spread": {f"{t:g}": (dprob <= t * spread).float().mean().item()
                                                 for t in (1e-3, 1e-2, 1e-1)},
        "max_abs_dprob": {s: (a[s]["prob_volume"] - b[s]["prob_volume"]).abs().max().item()
                          for s in ("stage1", "stage2", "stage3")},
    }


def forms_agree(result: dict, dtype_name: str) -> bool:
    agree_min = DENSE_AGREE_MIN[dtype_name]
    return (result["stage3_depth_within_one_interval"] >= agree_min
            and result["stage3_prob_columns_within_tol"] >= agree_min)


def cost_reg_agreement(model, forward, out: dict, interval: float, what: str) -> dict:
    """The forward with the cost regulariser's other form against ``out``
    (the default form's), same weights and inputs, in full float32
    arithmetic (see DENSE_AGREE_MIN); then the dense form with a planted
    band fault against the 3-D form, which the gate must reject."""
    dtype_name = model.cfg.compute_dtype
    other = not model.cfg.dense_cost_reg
    with cost_reg_form(model, other):
        twin = forward()
    result = {"form": "dense" if other else "3d", **form_agreement(twin, out, interval, dtype_name),
              "gate": {"agree_min": DENSE_AGREE_MIN[dtype_name], "prob_tol": DENSE_PROB_TOL[dtype_name]}}
    with cost_reg_form(model, True), planted_band_fault(model):
        faulty = forward()
    result["planted_band_fault"] = form_agreement(faulty, out if other else twin, interval, dtype_name)
    print(f"{what}, other cost regularisation: " + json.dumps(result), flush=True)
    if not forms_agree(result, dtype_name):
        raise AssertionError(f"{what}: the two cost regularisation forms disagree: {result}")
    if forms_agree(result["planted_band_fault"], dtype_name):
        raise AssertionError(f"{what}: the forms' gate passed a planted band fault: {result}")
    return result


def per_view_forward(model, forward, within_interval, what: str) -> dict:
    """One forward with FeatureNet run once per view
    (``batch_views_jointly=False``): its launches (FORWARD_LAUNCHES
    "inference_per_view"), its time and its stage-3 depth against the
    joint forward's (eval mode: the same function, other batch sizes)."""
    with configured(model, batch_views_jointly=False):
        forward()
        torch.cuda.synchronize()
        reset_launches()
        per_view = forward()
        torch.cuda.synchronize()
        launches = read_launches()
        ms = cuda_ms(forward, iters=1, warmup=0)
    result = {"launches": launches, "ms_per_depth_map": ms,
              "stage3_depth_within_one_interval_of_joint": within_interval(per_view)}
    print(f"{what}, per-view features: " + json.dumps(result), flush=True)
    expect_launches(launches, FORWARD_LAUNCHES["inference_per_view"], 1, f"{what}, per-view features")
    if not all(torch.isfinite(per_view[s]["prob_volume"]).all() for s in ("stage1", "stage2", "stage3")):
        raise AssertionError(f"{what}, per-view features: non-finite output")
    return result


def train_path(dev, sfx: str) -> dict:
    """The training path "train" + ``sfx`` (see PATH_CONFIGS)."""
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.example import example_train_batch
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.train.loop import to_device_batch
    from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
    from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

    dtype_name, fused = PATH_CONFIGS[sfx]
    what = f"train path ({dtype_name}{', fused view sum' if fused else ''})"
    cfg = ModelConfig(ndepths=NDEPTHS, compute_dtype=dtype_name, fused_view_sum=fused)
    # The reference's initialisation (offset convs at zero), seeded.
    model = TransMVSNet(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    # DTU-recipe inputs: example cameras, a smooth depth target inside the
    # hypothesis range, all-ones masks.
    batch = to_device_batch(example_train_batch(B=TRAIN_B, V=V, H=TRAIN_H, W=TRAIN_W, num_hyp=NUM_HYP), dev)
    state = TrainState(model, *make_optimizer(model.parameters(), warmup_multistep(1e-3, [10**6], 0.5)))
    train_step = make_train_step()
    losses = []

    def run(mark=None):
        _, scalars = train_step(state, batch, mark)
        losses.append(scalars["loss"].item())
        if scalars["skipped_nan"].item():
            raise AssertionError(f"{what}: train step skipped a non-finite loss: {losses}")

    marks: dict[str, list] = {k: [] for k in ("start", "forward", "backward", "optimizer")}

    def mark(phase):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks[phase].append(e)

    # Timed in the arithmetic tools/train.py runs: PyTorch's default, in
    # which cuDNN may use TF32 (the fused DCN backward's offset recompute
    # turns it off for itself). The rest of this script runs in full
    # float32.
    with cudnn_default_arithmetic():
        run()  # warm-up: cuDNN plans, the allocator, offsets off the integers
        torch.cuda.synchronize()
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        for _ in range(TRAIN_STEPS):
            mark("start")
            run(mark)
        torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    print(f"{what}: {TRAIN_STEPS} steps, launches {launches}", flush=True)
    expect_launches(launches, STEP_LAUNCHES["train" + sfx], TRAIN_STEPS, what)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: non-finite loss: {losses}")
    changed = sum(int(not torch.equal(a, p.detach())) for a, p in zip(before, model.parameters()))
    if changed != len(before):
        raise AssertionError(f"{what}: only {changed} of {len(before)} parameter tensors changed")
    split = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for i in range(TRAIN_STEPS):
        prev = marks["start"][i]
        for phase in split:
            split[phase] += prev.elapsed_time(marks[phase][i]) / TRAIN_STEPS
            prev = marks[phase][i]
    ms_per_step = sum(split.values())

    result = {
        "dtype": dtype_name,
        "fused_view_sum": fused,
        "ms_per_step": ms_per_step,
        "ms_by_phase": split,
        "depth_maps_trained_per_s": 1e3 * TRAIN_B / ms_per_step,
        "peak_memory_bytes": peak,
        "launches": launches,
        "launches_per_step": per_step,
        "losses": losses,
        "losses_falling": losses[-1] < losses[0],
    }
    print(f"{what}: " + json.dumps(result), flush=True)
    if not result["losses_falling"]:
        raise AssertionError(f"{what}: the loss did not fall over {len(losses)} steps: {losses}")
    # The gradients are compared at the state every path reaches here
    # (after 1 + TRAIN_STEPS steps): the in-turn timing below trains on.
    result["gradients"] = grad_comparison(model, state, run, dtype_name, fused)
    with cudnn_default_arithmetic():
        result["ms_per_step_in_turns"] = in_turns(run, TRAIN_STEPS, view_sums(model) if fused else cost_reg_forms(model))
    print(f"{what}: ms per step in turns {json.dumps(result['ms_per_step_in_turns'])}", flush=True)
    if not fused:
        result["other_cost_reg_gradients"] = cost_reg_gradients(model, state, run, dtype_name, what)
    return result


def restorer(model, state):
    """A function that puts the model's weights and buffers, the optimizer's
    and the schedule's state back as they are now."""
    model_sd = {k: v.clone() for k, v in model.state_dict().items()}
    opt_sd = copy.deepcopy(state.optimizer.state_dict())
    sched_sd = state.scheduler.state_dict()

    def restore():
        model.load_state_dict(model_sd)
        state.optimizer.load_state_dict(copy.deepcopy(opt_sd))
        state.scheduler.load_state_dict(sched_sd)

    return restore


def cost_reg_gradients(model, state, run, dtype_name: str, what: str) -> dict:
    """One step's gradients with the cost regulariser's other form against
    the default form's, from the same weights, batch, optimizer state and
    BN buffers, in full float32 arithmetic, per GRAD_GROUPS; beside the
    default form's step repeated (cuDNN's atomics). See
    DENSE_GRAD_COSINE_MIN."""
    restore = restorer(model, state)
    default = model.cfg.dense_cost_reg
    grads = {}
    for name, dense in (("default", default), ("other", not default), ("default_repeat", default)):
        restore()
        with cost_reg_form(model, dense):
            run()
        grads[name] = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    result = {"other_form": "3d" if default else "dense",
              "cosine": group_cosines(grads["other"], grads["default"]),
              **tensor_errors(grads["other"], grads["default"]),
              "witness_default_repeated": group_cosines(grads["default_repeat"], grads["default"])}
    print(f"{what}, other cost regularisation's gradients: " + json.dumps(result), flush=True)
    if dtype_name == "float32":
        low = {k: c for k, c in result["cosine"].items() if not c >= DENSE_GRAD_COSINE_MIN}
        if low:
            raise AssertionError(f"{what}: the forms' gradient cosine below {DENSE_GRAD_COSINE_MIN}: {low}")
    elif not result["cosine"]["all"] >= GRAD_COSINE_MIN:
        raise AssertionError(f"{what}: the forms' gradient cosine below {GRAD_COSINE_MIN}: {result['cosine']}")
    return result


def remat_path(dev) -> dict:
    """Phase 5's float32 step at the DTU recipe with ``ModelConfig.remat``
    and without, on one model: ms per step and peak memory of each (after
    a warm-up, TRAIN_STEPS steps, the CLI's arithmetic) and in turns, the
    launches per step exactly (STEP_LAUNCHES "train_f32_remat"), then one
    step of each from the same state in full float32: gradients per group
    (REMAT_COSINE_MIN), BatchNorm's running statistics and counts."""
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.example import example_train_batch
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.train.loop import to_device_batch
    from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
    from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

    what = "remat path (float32)"
    model = TransMVSNet(ModelConfig(ndepths=NDEPTHS), device=dev, generator=torch.Generator().manual_seed(0))
    batch = to_device_batch(example_train_batch(B=TRAIN_B, V=V, H=TRAIN_H, W=TRAIN_W, num_hyp=NUM_HYP), dev)
    state = TrainState(model, *make_optimizer(model.parameters(), warmup_multistep(1e-3, [10**6], 0.5)))
    train_step = make_train_step()

    def run():
        _, scalars = train_step(state, batch)
        if scalars["skipped_nan"].item():
            raise AssertionError(f"{what}: a step skipped a non-finite loss")

    result = {"ms_per_step": {}, "peak_memory_bytes": {}, "launches": {}}
    with cudnn_default_arithmetic():
        for remat in (False, True):
            key = "remat" if remat else "no_remat"
            with configured(model, remat=remat):
                run()  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                result["ms_per_step"][key] = cuda_ms(run, iters=TRAIN_STEPS, warmup=0)
                result["launches"][key] = read_launches()
                result["peak_memory_bytes"][key] = torch.cuda.max_memory_allocated()
        result["ms_per_step_in_turns"] = in_turns(run, TRAIN_STEPS, {
            "no_remat": lambda: configured(model, remat=False), "remat": lambda: configured(model, remat=True)})
    expect_launches(result["launches"]["no_remat"], STEP_LAUNCHES["train_f32"], TRAIN_STEPS, what + " without remat")
    expect_launches(result["launches"]["remat"], STEP_LAUNCHES["train_f32_remat"], TRAIN_STEPS, what)

    restore = restorer(model, state)
    grads, buffers = {}, {}
    for remat in (False, True):
        restore()
        with configured(model, remat=remat):
            run()
        grads[remat] = {n: p.grad.float().clone() for n, p in model.named_parameters()}
        buffers[remat] = {n: b.clone() for n, b in model.named_buffers()}
    stats = [n for n in buffers[False] if not n.endswith("num_batches_tracked")]
    result["cosine_vs_no_remat"] = group_cosines(grads[True], grads[False])
    result["running_stats_max_rel_err"] = max(
        ((buffers[True][n] - buffers[False][n]).abs().max() / buffers[False][n].abs().max().clamp_min(1e-30)).item()
        for n in stats)
    result["running_stats_bitwise_equal"] = all(torch.equal(buffers[True][n], buffers[False][n]) for n in stats)
    result["counts_equal"] = all(torch.equal(buffers[True][n], b) for n, b in buffers[False].items()
                                 if n.endswith("num_batches_tracked"))
    print(f"{what}: " + json.dumps(result), flush=True)
    low = {k: c for k, c in result["cosine_vs_no_remat"].items() if not c >= REMAT_COSINE_MIN}
    if low or not result["counts_equal"] or not result["running_stats_max_rel_err"] <= 1e-6:
        raise AssertionError(f"{what}: the remat step differs from the step without it: {result}")
    return result


def group_cosines(a: dict, b: dict) -> dict:
    """Cosine of two gradient sets over all parameters and over each group."""
    out = {}
    for group, member in {"all": lambda n: True, **GRAD_GROUPS}.items():
        names = [n for n in a if member(n)]
        dot = sum((a[n] * b[n]).sum().item() for n in names)
        na = sum(a[n].square().sum().item() for n in names) ** 0.5
        nb = sum(b[n].square().sum().item() for n in names) ** 0.5
        out[group] = dot / (na * nb) if na * nb > 0 else 0.0
    return out


def tensor_errors(a: dict, b: dict) -> dict:
    """Median and worst relative error of a against b over the tensors."""
    rel = {n: ((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-30)).item() for n in a}
    worst = max(rel, key=rel.get)
    return {"median_rel_err": float(np.median(list(rel.values()))), "worst": worst,
            "worst_rel_err": rel[worst]}


@contextlib.contextmanager
def patched(module, name, wrap):
    """``module.name`` replaced by ``wrap(original)`` inside the block."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def zero_outputs(*which):
    """Wraps a backward kernel so that the outputs at ``which`` are zero."""
    def wrap(fn):
        def faulty(*args, **kwargs):
            return tuple(torch.zeros_like(t) if i in which else t for i, t in enumerate(fn(*args, **kwargs)))
        return faulty
    return wrap


@contextlib.contextmanager
def nudged_dcn_outputs(model, seed: int):
    """Each DCN layer's output moved by one step of its dtype (bf16 or
    float32) up or down, or not at all, per element at random: the size of
    a DCN kernel's rounding difference from its plain version. The
    gradient passes unchanged."""
    from transmvsnet_tpu_torch.models.feature_net import DCN

    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)

    def hook(mod, args, out):
        with torch.no_grad():
            bits = torch.int16 if out.element_size() == 2 else torch.int32
            step = torch.randint(-1, 2, out.shape, generator=gen, device=out.device, dtype=bits)
            moved = (out.contiguous().view(bits) + step * (out != 0)).view(out.dtype)
            delta = moved - out
        return out + delta

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, DCN)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def grad_comparison(model, state, run, dtype_name: str, fused: bool) -> dict:
    """One step's gradients from the same weights, batch, optimizer state
    and BN buffers through the kernels and through each plain reference
    (see GRAD_COSINE_MIN), beside two witnesses of the noise (the plain
    step repeated, and with its DCN outputs nudged by one step of the
    activation type) and the kernel step with a fault planted in K3 and in
    K4 (and, on the fused path, in K8), which the per-group gate must
    catch. float32 also gates every group against the plain step
    (F32_COSINE_MIN)."""
    from transmvsnet_tpu_torch.ops import vjp
    from transmvsnet_tpu_torch.ops.cuda.dcn_bwd import dcn_bwd_plain
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import (
        warp_correlate_bwd_plain,
        warp_correlate_wsum_bwd_plain,
    )

    @contextlib.contextmanager
    def plain_backward():
        with patched(vjp, "dcn_bwd", lambda _: dcn_bwd_plain), \
                patched(vjp, "warp_correlate_bwd", lambda _: warp_correlate_bwd_plain), \
                patched(vjp, "warp_correlate_wsum_bwd", lambda _: warp_correlate_wsum_bwd_plain):
            yield

    restore = restorer(model, state)
    runs = {  # name: (plain ops, context, reference)
        "plain": (True, contextlib.nullcontext, None),
        "kernels": (False, contextlib.nullcontext, "plain"),
        "plain_repeat": (True, contextlib.nullcontext, "plain"),
        "plain_nudged": (True, lambda: nudged_dcn_outputs(model, seed=2), "plain"),
        "plain_backward": (False, plain_backward, None),
        "kernels_vs_plain_backward": (False, contextlib.nullcontext, "plain_backward"),
        "fault_k3_no_offset_grad": (False, lambda: patched(vjp, "dcn_bwd", zero_outputs(1, 2)), "plain_backward"),
        "fault_k4_no_dsrc": (False, lambda: patched(vjp, "warp_correlate_bwd", zero_outputs(0)), "plain_backward"),
    }
    faults = ["fault_k3_no_offset_grad", "fault_k4_no_dsrc"]
    if fused:
        runs["fault_k8_no_dsrc"] = (False, lambda: patched(vjp, "warp_correlate_wsum_bwd", zero_outputs(0)),
                                    "plain_backward")
        faults.append("fault_k8_no_dsrc")
    f32 = dtype_name == "float32"
    bwd_min = BWD_COSINE_MIN[dtype_name]
    grads = {}
    what = f"train path ({dtype_name}{', fused view sum' if fused else ''})"
    result = {"dtype": dtype_name, "fused_view_sum": fused, "bwd_cosine_min": bwd_min,
              **({"group_cosine_min": F32_COSINE_MIN} if f32 else {"cosine_min": GRAD_COSINE_MIN})}
    for name, (plain, context, ref) in runs.items():
        restore()
        model.use_plain_ops(plain)
        with context():
            run()
        grads[name] = {n: p.grad.float().clone() for n, p in model.named_parameters()}
        if ref:
            result[name] = {"vs": ref, "cosine": group_cosines(grads[name], grads[ref]),
                            **tensor_errors(grads[name], grads[ref])}
    model.use_plain_ops(False)
    print(f"{what} gradients: " + json.dumps(result), flush=True)
    if f32:
        low = {k: c for k, c in result["kernels"]["cosine"].items() if not c >= F32_COSINE_MIN}
        if low:
            raise AssertionError(f"gradient cosine vs the plain path below {F32_COSINE_MIN}: {low}")
    elif not result["kernels"]["cosine"]["all"] >= GRAD_COSINE_MIN:
        raise AssertionError(f"gradient cosine vs the plain path below {GRAD_COSINE_MIN}: {result['kernels']}")
    low = {k: c for k, c in result["kernels_vs_plain_backward"]["cosine"].items() if not c >= bwd_min}
    if low:
        raise AssertionError(f"gradient cosine vs the plain backward below {bwd_min}: {low}")
    for name in faults:
        if min(result[name]["cosine"].values()) >= bwd_min:
            raise AssertionError(f"the gradient gate misses the planted {name}: {result[name]}")
    return result


# --- Phase 6: the evaluation pipeline --------------------------------------

# Peaked probability volumes: the cost regularisers' first conv scaled by
# this gain (tests/test_torch_infer_cli.py::_model uses 1e3 at 64x64) keeps
# most blended confidences above the fusers' 0.3 (DTU) and 0.18 (TnT) cuts.
PIPELINE_GAIN = 1e5
CODEC_MEAN_MAX, CODEC_MAX = 1.0, 16  # nvJPEG against libjpeg, in levels
DTU_SOURCE_HW, DTU_SCENE_VIEWS, DTU_NUM_VIEW = (1200, 1600), 6, 5
TNT_SOURCE_HW, TNT_SCENE_VIEWS, TNT_NUM_VIEW = (1080, 1920), 12, 11
TRUE_SCAN_HW, TRUE_SCAN_VIEWS = (864, 1152), 4
# The true-depth scan in millimetres, as DTU's: the plane ~600 mm away (DTU
# 425-935 mm), so that the scorer's 0.2 mm spacing and 20 mm outlier cap
# mean what they mean on DTU; GT_SAMPLES surface points per view.
TRUE_SCAN_MM, GT_SAMPLES = 100.0, 250_000
PFM_AGREE_MIN = 0.999  # share of pixels whose CLI depth is within one stage-3 interval
PFM_CONF_TOL = 1e-5  # max |dconf| against the in-memory forward (same batch, same kernels)
# Batch 2 against batch 1, both in full float32: cuDNN picks other
# algorithms for batch 2, whose float32 rounding the gain amplifies in the
# softmax. In full float32 the worst view's mean |dconf| read 4.6e-5 and
# 99.95% of its depths were equal (max |dconf| 0.35); with TF32 convs (the
# CLI's arithmetic) 7.8e-3 and 89.4%; at a gain of 1e3, 1e-8 and 100% (on
# an NVIDIA H100 80GB HBM3 at 700 W). Gated on the mean, in full float32.
BATCH_CONF_MEAN_TOL = 1e-4
MASK_AGREE_MIN = 0.9999  # the card's fuser against the CPU's: kept-pixel masks
POINT_TOL = 1e-4  # ... and points, times the scene's depth range
SCORE_MAX = 0.5  # tests/test_cli_pipeline.py::test_dtu_fuse_then_evaluate's bound
NATIVE_DISP, NATIVE_CONSISTENT = 0.25, 3  # tools/fuse.py's --disp_threshold, --num_consistent
DECODE_REPEATS = 20
# Phase 6's scans, (b)'s output trees, fused at 1 and at FUSE_WORKERS workers, in turns
# (1, 4, 4, 1), FUSE_WORKERS_ROUNDS times: each four-worker run starts four processes.
FUSE_WORKERS_TREES = ("float32_batch1", "bfloat16_batch1", "float32_batch1_full_float32",
                      "float32_batch2_full_float32")
FUSE_WORKERS, FUSE_WORKERS_ROUNDS = 4, 1


def focal_for(width: int) -> float:
    """The synthetic scene's field of view (focal 120 px at 96 px wide)."""
    from transmvsnet_tpu_torch.data.synthetic import FOCAL

    return FOCAL * width / 96


def levels(img: torch.Tensor) -> np.ndarray:
    """A [0, 1] float image read by ``read_image`` back in uint8 levels."""
    return (img * 255).round().to(torch.uint8).cpu().numpy().astype(np.int64)


def paeth_png(img: np.ndarray) -> bytes:
    """An RGB PNG whose rows all use the Paeth filter (the sequential case
    of the decoder), encoded here with numpy and zlib."""
    import struct
    import zlib

    h, w, _ = img.shape
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = ((x - pred) & 255).astype(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.full((h, 1), 4, np.uint8), rows], axis=1).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def codec_checks(dev, work) -> dict:
    """(a) nvJPEG against the committed libjpeg decodes; decode time at the
    DTU and TnT source sizes; the JPEG and PNG round trips; the PNG
    decoder's time on a 640x512 image of Paeth rows."""
    import pathlib
    import time

    from transmvsnet_tpu_torch.data import image_io
    from transmvsnet_tpu_torch.data.synthetic import SyntheticScene

    fixtures = pathlib.Path(__file__).resolve().parent / "tests" / "data" / "torch_codec"
    def diff(got, want):
        d = np.abs(got - want)
        return {"mean_abs_levels": float(d.mean()), "max_abs_levels": int(d.max())}

    out = {"fixtures": {}, "jpeg_round_trip": {}}
    for name in ("synthetic_420", "synthetic_444"):
        out["fixtures"][name] = diff(levels(image_io.read_image(str(fixtures / f"{name}.jpg"), dev)),
                                     np.load(fixtures / f"{name}.npy"))
    for (h, w), key in ((DTU_SOURCE_HW, "dtu"), (TNT_SOURCE_HW, "tnt")):
        img, _ = SyntheticScene(1, h, w, seed=0, focal=focal_for(w)).render(0)
        u8 = torch.from_numpy((img * 255).astype(np.uint8))
        path = str(work / f"{key}.jpg")
        image_io.write_jpeg(path, u8.to(dev))
        out["jpeg_round_trip"][key] = diff(levels(image_io.read_image(path, dev)), u8.numpy())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_REPEATS):
            image_io.read_image(path, dev)
        torch.cuda.synchronize()
        out[f"ms_per_decoded_image_{key}_{w}x{h}"] = (time.perf_counter() - t0) / DECODE_REPEATS * 1e3
    img, _ = SyntheticScene(1, 512, 640, seed=0, focal=focal_for(640)).render(0)
    u8 = (img * 255).astype(np.uint8)
    png = paeth_png(u8)
    t0 = time.perf_counter()
    decoded = image_io.decode_png(png)
    out["ms_per_png_decode_640x512_paeth"] = (time.perf_counter() - t0) * 1e3
    out["png_bit_exact"] = bool(np.array_equal(decoded, u8)
                                and np.array_equal(image_io.decode_png(image_io.encode_png(u8)), u8))
    print("evaluation pipeline, codec: " + json.dumps(out), flush=True)
    bad = [k for group in ("fixtures", "jpeg_round_trip") for k, v in out[group].items()
           if not (v["mean_abs_levels"] <= CODEC_MEAN_MAX and v["max_abs_levels"] <= CODEC_MAX)]
    if bad or not out["png_bit_exact"]:
        raise AssertionError(f"codec gate (mean <= {CODEC_MEAN_MAX}, max <= {CODEC_MAX} levels; PNG "
                             f"bit for bit) fails at {bad or 'png'}: {out}")
    return out


def pipeline_checkpoint(path) -> None:
    """Seeded weights as tests/test_torch_infer_cli.py::_model makes them,
    with PIPELINE_GAIN, saved in the reference's .ckpt layout."""
    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet

    model = TransMVSNet(ModelConfig(ndepths=NDEPTHS), device="cpu", generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".conv_offset_mask." in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
            elif name.startswith("cost_regularization.") and name.endswith("conv0.conv.weight"):
                p.mul_(PIPELINE_GAIN)
    torch.save({"model": model.state_dict()}, path)


def run_infer(args: list, per_pass: dict, passes: int, maps: int, views: int, what: str,
              cli_arithmetic: bool = True) -> dict:
    """tools/infer.main in the CLI's arithmetic (or, if not
    ``cli_arithmetic``, in full float32), with its kernel launches, nvJPEG
    decodes (views per map) and encodes (one per map) counted and the peak
    memory read."""
    import time

    from transmvsnet_tpu_torch.data import image_io
    from transmvsnet_tpu_torch.tools import infer

    reset_launches()
    image_io.jpeg_decode.launches = image_io.jpeg_encode.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cudnn_default_arithmetic() if cli_arithmetic else contextlib.nullcontext():
        seconds = infer.main(args)
    wall = time.perf_counter() - t0
    launches = read_launches()
    expect_launches(launches, per_pass, passes, what)
    coded = (image_io.jpeg_decode.launches, image_io.jpeg_encode.launches)
    if coded != (maps * views, maps):
        raise AssertionError(f"{what}: {coded} nvJPEG decodes and encodes, expected {(maps * views, maps)}")
    return {"wall_s": wall, "iteration_s": seconds, "launches": launches, "jpeg_decodes": coded[0],
            "jpeg_encodes": coded[1], "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def compare_pfms(out_dir, scan: str, views, forward, interval: float) -> dict:
    """Each view's PFM depth and confidence against ``forward(view)``, the
    (depth, confidence) the CLI should have written."""
    from transmvsnet_tpu_torch.data.pfm import read_pfm

    agree, conf_max, conf_mean = [], 0.0, 0.0
    for v in views:
        depth, conf = forward(v)
        got_d = read_pfm(f"{out_dir}/{scan}/depth_est/{v:0>8}.pfm")[0]
        got_c = read_pfm(f"{out_dir}/{scan}/confidence/{v:0>8}.pfm")[0]
        agree.append(float((np.abs(got_d - depth) <= interval).mean()))
        conf_max = max(conf_max, float(np.abs(got_c - conf).max()))
        conf_mean = max(conf_mean, float(np.abs(got_c - conf).mean()))
    return {"depth_within_one_interval_min": min(agree), "max_abs_dconf": conf_max,
            "mean_abs_dconf_max_over_views": conf_mean}


def dtu_infer(dev, work, ckpt) -> dict:
    """(b) DTU shape through tools/infer.main: float32 (K5, K6) and bf16 (K1,
    K2) at batch 1 in the CLI's arithmetic, each PFM against the in-memory
    forward of the same model on the same decoded sample; float32 at batch
    2 against batch 1, both in full float32 (see BATCH_CONF_MEAN_TOL)."""
    import os

    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.datasets import GeneralEvalDataset
    from transmvsnet_tpu_torch.data.pfm import read_pfm
    from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet, blended_confidence
    from transmvsnet_tpu_torch.tools.infer import load_checkpoint

    data = work / "dtu"
    h, w = DTU_SOURCE_HW
    SyntheticDataset(nviews=DTU_SCENE_VIEWS, num_samples=1, height=h, width=w, ndepths=NUM_HYP,
                     focal=focal_for(w)).materialize(str(data), device=dev)
    os.rename(data / "synth0", data / "scan1")
    (work / "dtu.txt").write_text("scan1\n")
    common = ["--datapath", str(data), "--testlist", str(work / "dtu.txt"), "--loadckpt", str(ckpt),
              "--num_view", str(DTU_NUM_VIEW), "--numdepth", str(NUM_HYP), "--max_h", str(H), "--max_w", str(W),
              "--ndepths", ",".join(map(str, NDEPTHS))]
    maps = DTU_SCENE_VIEWS
    ds = GeneralEvalDataset(str(data), ["scan1"], nviews=DTU_NUM_VIEW, ndepths=NUM_HYP, max_h=H, max_w=W, device=dev)
    samples = {int(ds[i]["filename"].split("/")[-1][:8]): ds[i] for i in range(len(ds))}
    interval = 0.5 * float(samples[0]["depth_values"][1] - samples[0]["depth_values"][0])
    result = {}
    runs = (("float32", "_f32", 1, True), ("bfloat16", "", 1, True), ("float32", "_f32", 1, False),
            ("float32", "_f32", 2, False))
    for dtype, sfx, batch, cli in runs:
        key = f"{dtype}_batch{batch}" + ("" if cli else "_full_float32")
        out = work / f"dtu_out_{key}"
        r = run_infer([*common, "--outdir", str(out), "--dtype", dtype, "--batch_size", str(batch)],
                      FORWARD_LAUNCHES["inference" + sfx], -(-maps // batch), maps, DTU_NUM_VIEW,
                      f"DTU infer CLI ({key})", cli_arithmetic=cli)
        steady = r["iteration_s"][1:] or r["iteration_s"]
        r["cli_ms_per_depth_map"] = 1e3 * float(np.mean(steady)) / batch
        r["first_iteration_ms"] = 1e3 * r["iteration_s"][0]
        if not cli and batch == 1:
            result[key] = r
            print(f"evaluation pipeline, DTU infer {key}: " + json.dumps(r), flush=True)
            continue
        if batch == 1:
            model = TransMVSNet(ModelConfig(ndepths=NDEPTHS, compute_dtype=dtype), device=dev)
            load_checkpoint(model, str(ckpt))
            model.eval()

            def forward(v):
                s = samples[v]
                with torch.no_grad(), cudnn_default_arithmetic():
                    o = model(torch.from_numpy(s["imgs"][None]).to(dev),
                              {k: torch.from_numpy(p[None]).to(dev) for k, p in s["proj_matrices"].items()},
                              torch.from_numpy(s["depth_values"][None]).to(dev))
                    depth, conf = blended_confidence(o)
                return depth[0].cpu().numpy(), conf[0].cpu().numpy()

            r["vs_in_memory_forward"] = compare_pfms(out, "scan1", samples, forward, interval)
            del model
        else:
            base = work / "dtu_out_float32_batch1_full_float32"

            def forward(v):
                return (read_pfm(f"{base}/scan1/depth_est/{v:0>8}.pfm")[0],
                        read_pfm(f"{base}/scan1/confidence/{v:0>8}.pfm")[0])

            r["vs_batch1"] = compare_pfms(out, "scan1", samples, forward, interval)
        result[key] = r
        print(f"evaluation pipeline, DTU infer {key}: " + json.dumps(r), flush=True)
        if batch == 1:
            gate = r["vs_in_memory_forward"]
            conf_ok = gate["max_abs_dconf"] <= PFM_CONF_TOL
        else:
            gate = r["vs_batch1"]
            conf_ok = gate["mean_abs_dconf_max_over_views"] <= BATCH_CONF_MEAN_TOL
        if not (gate["depth_within_one_interval_min"] >= PFM_AGREE_MIN and conf_ok):
            raise AssertionError(f"DTU infer {key}: PFMs disagree (depth within one interval at >= "
                                 f"{PFM_AGREE_MIN}; confidence max {PFM_CONF_TOL} against the forward, "
                                 f"mean {BATCH_CONF_MEAN_TOL} against batch 1): {gate}")
        torch.cuda.empty_cache()
    result["scan"] = str(work / "dtu_out_float32_batch1")
    result["depth_range"] = float(samples[0]["depth_values"][-1] - samples[0]["depth_values"][0])
    return result


def card_vs_cpu_fusion(scan_dir: str, params, depth_range: float, what: str) -> dict:
    """Every reference view fused on the card and on CPU tensors: kept-pixel
    masks, and the points of pixels both keep."""
    from transmvsnet_tpu_torch.data.cams import read_pair_file
    from transmvsnet_tpu_torch.fusion.dynamic import fuse_view

    agree, worst, kept = [], 0.0, 0
    for ref, srcs in read_pair_file(f"{scan_dir}/pair.txt"):
        xyz_c, _, m_c = (t.cpu() for t in fuse_view(scan_dir, ref, srcs, params, torch.device("cuda")))
        xyz_p, _, m_p = fuse_view(scan_dir, ref, srcs, params, torch.device("cpu"))
        agree.append(float((m_c == m_p).double().mean()))
        both = (m_c & m_p).reshape(-1)
        idx_c = torch.cumsum(m_c.reshape(-1).long(), 0) - 1
        idx_p = torch.cumsum(m_p.reshape(-1).long(), 0) - 1
        if both.any():
            worst = max(worst, float((xyz_c[idx_c[both]] - xyz_p[idx_p[both]]).abs().max()))
        kept += int(m_c.sum())
    r = {"mask_agree_min": min(agree), "max_abs_dpoint": worst, "point_tol": POINT_TOL * depth_range,
         "points_on_card": kept}
    if not (r["mask_agree_min"] >= MASK_AGREE_MIN and worst <= POINT_TOL * depth_range):
        raise AssertionError(f"{what}: the card's fuser disagrees with the CPU's: {r}")
    return r


def native_bound(scan, ref: int, srcs: torch.Tensor, count: torch.Tensor) -> dict:
    """The least time of one reference view's native fusion on this data:
    the reference depth read once, each source pixel that a tap of a sample
    touches read once (a valid pixel's sample, in front of the source and
    inside it; neighbouring pixels' taps overlap, and a source's map stays
    in L2, so the 16 bytes of four taps per sample would count bytes the
    function need not move), the count and the point written for every
    pixel (16 bytes); float32 operations: 36 per valid pixel (its
    unprojection and mean), 30 per valid pixel and source (the projection),
    19 per sample inside (the bilinear sample, the disparities) and 36 per
    agreeing source (its point)."""
    from transmvsnet_tpu_torch.ops.native_fuse import bilinear_taps, camera, project, unproject

    h, w = scan.hw[ref]
    offs = scan.offsets.tolist()
    valid = count.reshape(-1) > 0
    y, x = torch.meshgrid(torch.arange(h, device=count.device), torch.arange(w, device=count.device),
                          indexing="ij")
    X = unproject(camera(scan.cams, ref), x.reshape(-1).float(), y.reshape(-1).float(),
                  scan.depths[offs[ref] : offs[ref] + h * w])
    inside = touched = 0
    for sv in srcs.tolist():
        u, v, _, front = project(camera(scan.cams, sv), X)
        sh, sw = scan.hw[sv]
        hit, taps, _, _ = bilinear_taps(sh, sw, u, v)
        hit = valid & front & hit
        inside += int(hit.sum())
        read = torch.zeros(sh * sw, dtype=torch.bool, device=count.device)
        for i in taps:
            read[i[hit]] = True
        touched += int(read.sum())
    n_valid = int(valid.sum())
    agreeing = int((count.reshape(-1)[valid] - 1).sum())
    nbytes = 4 * h * w + min(16 * inside, 4 * touched) + 16 * h * w
    flops = 36 * n_valid + 30 * n_valid * len(srcs) + 19 * inside + 36 * agreeing
    return {"samples_inside": inside, "source_pixels_read": touched, **bound(nbytes, flops, torch.float32)}


def native_launch(args):
    """A closure that launches the native fuser's kernel on ``args`` (as
    ``native_fuse`` takes them) and nothing else: contiguous inputs, the
    outputs and the library are made once, as the wrapper makes them."""
    from transmvsnet_tpu_torch.ops.cuda import build
    from transmvsnet_tpu_torch.ops.cuda.native_fuse import launch

    depths, offsets, sizes, cams, ref, (h, w), srcs, fbs, lo, hi, thr = args
    tensors = [t.contiguous() for t in (depths, offsets, sizes, cams, srcs, fbs)]
    count = torch.empty((h, w), dtype=torch.int32, device=depths.device)
    xyz = torch.empty((h, w, 3), dtype=torch.float32, device=depths.device)
    lib = build.library("native_fuse")
    return lambda: build.check(lib, "native_fuse", launch(lib, *tensors, ref, (h, w), lo, hi, thr, count, xyz,
                                                           build.stream_handle(depths)))


def native_vs_plain(scan_dir: str, depth_range: float, what: str) -> dict:
    """Every reference view's native-fuser kernel against its plain version,
    both on the card, on the same loaded scan: counts and points equal bit
    for bit (both round every operation alike), and the gates of
    ``card_vs_cpu_fusion`` on the kept-pixel masks (count >=
    NATIVE_CONSISTENT) and the points of pixels both keep. Per reference
    view: "ms", the kernel's device time alone, replayed from a CUDA graph
    (``compare_dcn.kernel_ms``); "call_ms", the wrapper's per call by CUDA
    events (its host work included); the plain version's; the view's bound.
    These launches are not the path's: the CLI's run counts them."""
    from transmvsnet_tpu_torch.fusion import native
    from transmvsnet_tpu_torch.ops.cuda.native_fuse import native_fuse
    from transmvsnet_tpu_torch.ops.native_fuse import native_fuse_view_plain
    from transmvsnet_tpu_torch.tools.compare_dcn import kernel_ms

    scan = native.load_scan(scan_dir, "cuda")
    views = []
    for ref, srcs, fbs in scan.entries:
        args = (scan.depths, scan.offsets, scan.sizes, scan.cams, ref, scan.hw[ref], srcs, fbs, 0.0, 1e9,
                NATIVE_DISP)
        count, xyz = native_fuse(*args)
        want_count, want_xyz = native_fuse_view_plain(*args)
        keep, want_keep = count >= NATIVE_CONSISTENT, want_count >= NATIVE_CONSISTENT
        both = keep & want_keep
        views.append({
            "ref": ref, "hw": scan.hw[ref], "sources": len(srcs), "kept": int(keep.sum()),
            "mask_agree": float((keep == want_keep).double().mean()),
            "max_abs_dpoint": float((xyz - want_xyz)[both].abs().max()) if both.any() else 0.0,
            "bitwise_equal": torch.equal(count, want_count) and torch.equal(xyz, want_xyz),
            "ms": kernel_ms(native_launch(args), iters=20, replays=5),
            "call_ms": cuda_ms(lambda: native_fuse(*args), iters=20),
            "plain_ms": cuda_ms(lambda: native_fuse_view_plain(*args), iters=3, warmup=1),
            **native_bound(scan, ref, srcs, count)})
    r = {"mask_agree_min": min(v["mask_agree"] for v in views),
         "max_abs_dpoint": max(v["max_abs_dpoint"] for v in views), "point_tol": POINT_TOL * depth_range,
         "all_bitwise_equal": all(v["bitwise_equal"] for v in views), "views": views}
    if not (r["all_bitwise_equal"] and r["mask_agree_min"] >= MASK_AGREE_MIN
            and r["max_abs_dpoint"] <= r["point_tol"]):
        raise AssertionError(f"{what}: the native fuser's kernel disagrees with its plain version: {r}")
    return r


def native_cli(args: list, views: int, ply: str, what: str) -> dict:
    """tools/fuse.main --filter_method native, its launches counted: one
    native_fuse launch per reference view and no other kernel."""
    from transmvsnet_tpu_torch.fusion.ply import read_ply
    from transmvsnet_tpu_torch.tools import fuse

    reset_launches()
    s = timed_cli(fuse.main, [*args, "--filter_method", "native"])
    launches = read_launches()
    expect_launches(launches, {"native_fuse": views}, 1, what)
    xyz, rgb = read_ply(ply)
    if not (np.isfinite(xyz).all() and rgb is not None):
        raise AssertionError(f"{what}: non-finite points or no colours")
    return {"ms_per_scan": 1e3 * s, "ms_per_reference_view": 1e3 * s / views, "points": len(xyz),
            "launches": launches["native_fuse"]}


def timed_cli(fn, args: list) -> float:
    import time

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def fusion_workers(dev, work, smi: str) -> dict:
    """(b)'s four output trees (float32 and bf16 in the CLI's arithmetic,
    float32 at batch 1 and 2 in full float32), their scan linked as
    scan1..scan4, fused through tools/fuse.main (dynamic) at --num_workers 1
    and 4 in turns (1, 4, 4, 1): ms per scan, the four-worker runs' start
    of four spawned processes included, and the peak device memory in use
    by all processes above the level before the run. Gates: the four scans
    write four different PLYs, each run writes each scan's PLY byte for
    byte as the first one-worker run, and prints them in testlist order."""
    import contextlib
    import io
    import os

    from transmvsnet_tpu_torch.tools import fuse
    from transmvsnet_tpu_torch.tools.time_fusion_workers import DeviceMemory

    root = work / "workers"
    root.mkdir()
    trees = FUSE_WORKERS_TREES
    scans = [f"scan{i}" for i in range(1, len(trees) + 1)]
    for scan, tree in zip(scans, trees):
        os.symlink(work / f"dtu_out_{tree}" / "scan1", root / scan, target_is_directory=True)
    (work / "workers.txt").write_text("".join(f"{scan}\n" for scan in scans))
    runs = {1: [], FUSE_WORKERS: []}
    for turn, workers in enumerate((1, FUSE_WORKERS, FUSE_WORKERS, 1) * FUSE_WORKERS_ROUNDS):
        plys = work / f"plys_workers_{turn}"
        buf = io.StringIO()
        with DeviceMemory(dev) as memory, contextlib.redirect_stdout(buf):
            s = timed_cli(fuse.main, ["--testpath", str(root), "--testlist", str(work / "workers.txt"), "--outdir",
                                      str(plys), "--test_dataset", "dtu", "--num_workers", str(workers)])
        wrote = [line.split(" ", 1)[1] for line in buf.getvalue().splitlines() if line.startswith("wrote ")]
        want = [str(plys / f"mvsnet{i:03d}_l3.ply") for i in range(1, len(scans) + 1)]
        if wrote != want:
            raise AssertionError(f"fusion at {workers} workers printed {wrote}, not the testlist's order {want}")
        runs[workers].append({"s": s, "peak": memory.peak_bytes,
                              "plys": [open(p, "rb").read() for p in wrote]})
    first = runs[1][0]["plys"]
    if len(set(first)) != len(first):
        raise AssertionError(f"two of the trees {trees} fused to the same PLY: a swapped scan would not show")
    for n, rs in runs.items():
        for r in rs:
            differ = [tree for tree, mine, want in zip(trees, r["plys"], first) if mine != want]
            if differ:
                raise AssertionError(f"fusion at {n} workers wrote other PLYs than at 1 for {differ}")
    ms = {n: [1e3 * x["s"] / len(scans) for x in rs] for n, rs in runs.items()}
    r = {"scans": dict(zip(scans, trees)), "ms_per_scan_by_workers": ms,
         "median_ms_per_scan_by_workers": {n: float(np.median(v)) for n, v in ms.items()},
         "peak_device_memory_bytes_by_workers": {n: max(x["peak"] for x in rs) for n, rs in runs.items()},
         "ply_bytes": [len(b) for b in first], "plys_byte_identical": True}
    print("evaluation pipeline, DTU fusion across scans (" + smi + "): " + json.dumps(r), flush=True)
    return r


def write_true_scan(dev, root) -> tuple:
    """The synthetic scene's true depth maps as a fusion scan (confidence 1,
    as tests/test_cli_pipeline.py:85-118 writes them), scaled to
    millimetres (TRUE_SCAN_MM), and DTU-layout ground truth: surface points
    unprojected from the true depths, an all-ones observability mask over
    their box, and a ground plane below."""
    import os

    from scipy.io import savemat

    from transmvsnet_tpu_torch.data.cams import write_cam_file
    from transmvsnet_tpu_torch.data.image_io import write_jpeg
    from transmvsnet_tpu_torch.data.pfm import save_pfm
    from transmvsnet_tpu_torch.data.synthetic import SyntheticScene
    from transmvsnet_tpu_torch.fusion.ply import write_ply

    h, w = TRUE_SCAN_HW
    scene = SyntheticScene(TRUE_SCAN_VIEWS, h, w, seed=0, focal=focal_for(w))
    scan = root / "true" / "scan1"
    for sub in ("depth_est", "confidence", "cams", "images"):
        os.makedirs(scan / sub)
    rng = np.random.RandomState(0)
    surface = []
    depths = []
    for v in range(scene.V):
        img, depth = scene.render(v)
        depth = (depth * TRUE_SCAN_MM).astype(np.float32)
        depths.append(depth)
        E = scene.extrinsics[v].copy()
        E[:3, 3] *= TRUE_SCAN_MM
        save_pfm(str(scan / f"depth_est/{v:0>8}.pfm"), depth)
        save_pfm(str(scan / f"confidence/{v:0>8}.pfm"), np.ones_like(depth))
        pair = np.zeros((2, 4, 4), dtype=np.float32)
        pair[0] = E
        pair[1, :3, :3] = scene.K
        write_cam_file(str(scan / f"cams/{v:0>8}_cam.txt"), pair, "1.0 0.01")
        write_jpeg(str(scan / f"images/{v:0>8}.jpg"), torch.from_numpy((img * 255).astype(np.uint8)).to(dev))
        ys, xs = rng.randint(0, h, GT_SAMPLES), rng.randint(0, w, GT_SAMPLES)
        d = depth[ys, xs].astype(np.float64)
        cam = np.linalg.inv(scene.K) @ np.stack([xs * d, ys * d, d])
        surface.append((E[:3, :3].T @ (cam - E[:3, 3:4])).T)
    with open(scan / "pair.txt", "w") as f:
        f.write(f"{scene.V}\n")
        for v in range(scene.V):
            others = [o for o in range(scene.V) if o != v]
            f.write(f"{v}\n{len(others)} " + " ".join(f"{o} 10.0" for o in others) + "\n")
    stl = np.concatenate(surface).astype(np.float32)
    gt = root / "gt"
    os.makedirs(gt / "Points/stl")
    os.makedirs(gt / "ObsMask")
    write_ply(str(gt / "Points/stl/stl001_total.ply"), stl, np.full((len(stl), 3), 128, np.uint8))
    lo, hi = stl.min(0) - 5.0, stl.max(0) + 5.0
    dims = np.ceil(hi - lo).astype(int) + 1
    savemat(str(gt / "ObsMask/ObsMask1_10.mat"), {"ObsMask": np.ones(dims, np.uint8), "BB": np.stack([lo, hi]),
                                                  "Res": 1.0})
    savemat(str(gt / "ObsMask/Plane1.mat"), {"P": np.array([0.0, 0.0, 1.0, -1.0])})
    return str(root / "true"), str(gt), float(max(d.max() for d in depths) - min(d.min() for d in depths))


def fusion_and_scoring(dev, work, dtu) -> dict:
    """(c) tools/fuse.main, dynamic, normal and native, on (b)'s float32
    outputs on the card, dynamic and normal held against the CPU fuser,
    native's kernel against its plain version per reference view; the
    true-depth scan fused on the card with dynamic (held against the CPU)
    and with native (against the plain version), each scored by
    tools/eval_dtu.main."""
    import contextlib
    import io
    import time

    from transmvsnet_tpu_torch.fusion.dynamic import FusionParams
    from transmvsnet_tpu_torch.fusion.ply import read_ply
    from transmvsnet_tpu_torch.tools import eval_dtu, fuse

    out_root = str(work / "dtu_out_float32_batch1")
    result = {}
    for method, photo in (("dynamic", 0.3), ("normal", 0.9), ("native", None)):  # the CLI's DTU defaults
        plys = work / f"plys_{method}"
        args = ["--testpath", out_root, "--testlist", str(work / "dtu.txt"), "--outdir", str(plys),
                "--test_dataset", "dtu"]
        what = f"DTU fusion ({method})"
        if method == "native":
            r = native_cli(args, DTU_SCENE_VIEWS, str(plys / "mvsnet001_l3.ply"), what)
            r["vs_plain"] = native_vs_plain(f"{out_root}/scan1", dtu["depth_range"], what)
        else:
            s = timed_cli(fuse.main, [*args, "--filter_method", method])
            xyz, _ = read_ply(str(plys / "mvsnet001_l3.ply"))
            r = {"ms_per_scan": 1e3 * s, "ms_per_reference_view": 1e3 * s / DTU_SCENE_VIEWS, "points": len(xyz),
                 "vs_cpu": card_vs_cpu_fusion(f"{out_root}/scan1",
                                              FusionParams(photo_threshold=photo, thres_view=3, mode=method),
                                              dtu["depth_range"], what)}
            if not np.isfinite(xyz).all():
                raise AssertionError(f"{what}: non-finite points")
        result[method] = r
        print(f"evaluation pipeline, DTU fusion {method}: " + json.dumps(r), flush=True)

    true_root, gt, depth_range = write_true_scan(dev, work)
    (work / "true.txt").write_text("scan1\n")
    for method in ("dynamic", "native"):
        plys = work / f"plys_true_{method}"
        args = ["--testpath", true_root, "--testlist", str(work / "true.txt"), "--outdir", str(plys),
                "--test_dataset", "dtu"]
        what = f"true-depth fusion ({method})"
        if method == "native":
            r = native_cli(args, TRUE_SCAN_VIEWS, str(plys / "mvsnet001_l3.ply"), what)
            r["vs_plain"] = native_vs_plain(f"{true_root}/scan1", depth_range, what)
        else:
            s = timed_cli(fuse.main, [*args, "--photo_threshold", "0.5", "--thres_view", "2"])
            r = {"ms_per_scan": 1e3 * s, "ms_per_reference_view": 1e3 * s / TRUE_SCAN_VIEWS,
                 "vs_cpu": card_vs_cpu_fusion(f"{true_root}/scan1", FusionParams(photo_threshold=0.5, thres_view=2),
                                              depth_range, what)}
        xyz, _ = read_ply(str(plys / "mvsnet001_l3.ply"))
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            eval_dtu.main(["--plydir", str(plys), "--gtpath", gt, "--scans", "1"])
        r.update({"points": len(xyz), "scoring_s": time.perf_counter() - t0,
                  "score": json.loads(buf.getvalue().strip().splitlines()[-1])})
        key = "true_depth" if method == "dynamic" else "true_depth_native"
        result[key] = r
        print(f"evaluation pipeline, true-depth scan ({method}): " + json.dumps(r), flush=True)
        if not (len(xyz) > 0 and r["score"]["overall"] < SCORE_MAX):
            raise AssertionError(f"{what}: overall {r['score']['overall']} not below {SCORE_MAX} ({len(xyz)} points)")
    return result


def tnt_pipeline(dev, work, ckpt) -> dict:
    """(d) TnT shape: a 12-view scene at 1920x1080 in a TnT tree (cams_1/,
    minmax depth lines), every view a reference with the 11 others as
    sources (the fuser reads each source's depth map); infer with 11 views
    and inverse depth, fused with thres_view 5."""
    import os

    from transmvsnet_tpu_torch.data.cams import write_cam_file
    from transmvsnet_tpu_torch.data.image_io import write_jpeg
    from transmvsnet_tpu_torch.data.pfm import read_pfm
    from transmvsnet_tpu_torch.data.synthetic import SyntheticScene
    from transmvsnet_tpu_torch.fusion.ply import read_ply
    from transmvsnet_tpu_torch.tools import fuse

    h, w = TNT_SOURCE_HW
    scene = SyntheticScene(TNT_SCENE_VIEWS, h, w, seed=0, focal=focal_for(w))
    lo, hi = scene.depth_range()
    scan = work / "tnt" / "Horse"  # a 1920x1080 scene of TnTEvalDataset.IMAGE_SIZES
    os.makedirs(scan / "images")
    os.makedirs(scan / "cams_1")
    for v in range(scene.V):
        img, _ = scene.render(v)
        write_jpeg(str(scan / f"images/{v:0>8}.jpg"), torch.from_numpy((img * 255).astype(np.uint8)).to(dev))
        pair = np.zeros((2, 4, 4), dtype=np.float32)
        pair[0] = scene.extrinsics[v]
        pair[1, :3, :3] = scene.K
        write_cam_file(str(scan / f"cams_1/{v:0>8}_cam.txt"), pair, f"{lo:.6f} {hi:.6f}")
    with open(scan / "pair.txt", "w") as f:
        f.write(f"{scene.V}\n")
        for v in range(scene.V):
            others = sorted((o for o in range(scene.V) if o != v), key=lambda o: abs(o - v))
            f.write(f"{v}\n{len(others)} " + " ".join(f"{o} {100.0 - i}" for i, o in enumerate(others)) + "\n")
    (work / "tnt.txt").write_text("Horse\n")
    out = work / "tnt_out"
    r = run_infer(["--dataset", "tnt", "--datapath", str(work / "tnt"), "--testlist", str(work / "tnt.txt"),
                   "--outdir", str(out), "--loadckpt", str(ckpt), "--num_view", str(TNT_NUM_VIEW),
                   "--numdepth", str(NUM_HYP), "--ndepths", ",".join(map(str, NDEPTHS)), "--inverse_depth"],
                  FORWARD_LAUNCHES["inference_f32"], scene.V, scene.V, TNT_NUM_VIEW, "TnT infer CLI")
    steady = r["iteration_s"][1:]
    r["cli_ms_per_depth_map"] = 1e3 * float(np.mean(steady))
    finite = True
    for v in range(scene.V):
        depth = read_pfm(str(out / f"Horse/depth_est/{v:0>8}.pfm"))[0]
        conf = read_pfm(str(out / f"Horse/confidence/{v:0>8}.pfm"))[0]
        finite &= depth.shape == (h // 32 * 32, w) and bool(np.isfinite(depth).all() and np.isfinite(conf).all())
    s = timed_cli(fuse.main, ["--testpath", str(out), "--testlist", str(work / "tnt.txt"), "--outdir",
                              str(work / "plys_tnt"), "--test_dataset", "tnt", "--thres_view", "5"])
    xyz, rgb = read_ply(str(work / "plys_tnt/Horse.ply"))
    r.update({"outputs_finite": finite, "fusion_ms_per_scan": 1e3 * s,
              "fusion_ms_per_reference_view": 1e3 * s / scene.V, "points": len(xyz)})
    native = native_cli(["--testpath", str(out), "--testlist", str(work / "tnt.txt"), "--outdir",
                         str(work / "plys_tnt_native"), "--test_dataset", "tnt"], scene.V,
                        str(work / "plys_tnt_native/Horse.ply"), "TnT fusion (native)")
    native["vs_plain"] = native_vs_plain(str(out / "Horse"), hi - lo, "TnT fusion (native)")
    r["native"] = native
    print("evaluation pipeline, TnT: " + json.dumps(r), flush=True)
    if not (finite and len(xyz) > 0 and np.isfinite(xyz).all() and rgb is not None and native["points"] > 0):
        raise AssertionError(f"TnT pipeline: finite outputs {finite}, {len(xyz)} points, {native['points']} native")
    return r


def native_kernel_entry(checks: dict, launches: dict) -> dict:
    """The kernels line's entry of the native fuser: per reference view (one
    launch), headed by its main path, the DTU-shape scan's fusion through
    the CLI: its mean times and its launches there. The other native runs'
    are in "by_path" and "launches_by_path"."""
    def mean(views, key):
        return sum(v[key] for v in views) / len(views)

    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")
    by_path = {name: {key: mean(c["views"], key) for key in keys} for name, c in checks.items()}
    head = by_path["dtu"]
    return {
        "name": "native_fuse", "route": "cuda", "source": "transmvsnet_tpu_torch/csrc/native_fuse.cu",
        "replaces": "native/fuser/fuser.cpp:296", "launches": launches["dtu"],
        "max_abs_err": max(c["max_abs_dpoint"] for c in checks.values()),
        "ms": head["ms"], "call_ms": head["call_ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes" if head["bytes_ms"] >= head["ops_ms"] else "operations", "library_ms": None,
        "main_path": "dtu", "per": "reference view", "launches_by_path": launches, "by_path": by_path,
        "all_bitwise_equal": all(c["all_bitwise_equal"] for c in checks.values()),
    }


def evaluation_pipeline(dev, paths: dict, smi: str) -> tuple[dict, dict]:
    """Phase 6: read -> infer -> write -> fuse -> score through the port's
    CLIs on the card, in a scratch tree under build/ (git-ignored). Returns
    its summary and the native fuser's kernel entry."""
    import pathlib
    import shutil

    work = pathlib.Path(__file__).resolve().parent / "build" / "eval_pipeline"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ckpt = work / "peaked.ckpt"
    pipeline_checkpoint(ckpt)
    codec = codec_checks(dev, work)
    dtu = dtu_infer(dev, work, ckpt)
    fusion = fusion_and_scoring(dev, work, dtu)
    workers = fusion_workers(dev, work, smi)
    tnt = tnt_pipeline(dev, work, ckpt)
    native_runs = {"dtu": fusion["native"], "true_depth": fusion["true_depth_native"], "tnt": tnt["native"]}
    summary = {
        "ms_per_decoded_image": {k: v for k, v in codec.items() if k.startswith("ms_per_decoded")},
        "ms_per_png_decode_640x512_paeth": codec["ms_per_png_decode_640x512_paeth"],
        "cli_ms_per_depth_map": {
            "float32": dtu["float32_batch1"]["cli_ms_per_depth_map"],
            "bfloat16": dtu["bfloat16_batch1"]["cli_ms_per_depth_map"],
            "float32_batch1_full_float32": dtu["float32_batch1_full_float32"]["cli_ms_per_depth_map"],
            "float32_batch2_full_float32": dtu["float32_batch2_full_float32"]["cli_ms_per_depth_map"],
            "tnt_float32_11_views": tnt["cli_ms_per_depth_map"]},
        "model_only_ms_per_depth_map": {"float32": paths["inference_f32"]["ms_per_depth_map"],
                                        "bfloat16": paths["inference"]["ms_per_depth_map"]},
        "fusion_ms_per_reference_view": {**{k: v["ms_per_reference_view"] for k, v in fusion.items()},
                                         "tnt": tnt["fusion_ms_per_reference_view"],
                                         "tnt_native": tnt["native"]["ms_per_reference_view"]},
        "fusion_ms_per_scan": {**{k: v["ms_per_scan"] for k, v in fusion.items()},
                               "tnt": tnt["fusion_ms_per_scan"], "tnt_native": tnt["native"]["ms_per_scan"]},
        "fusion_points": {**{k: v["points"] for k, v in fusion.items()}, "tnt": tnt["points"],
                          "tnt_native": tnt["native"]["points"]},
        "fusion_across_scans": workers,
        "native_fuse_launches_per_scan": {k: v["launches"] for k, v in native_runs.items()},
        "native_kernel_ms_per_reference_view": {k: float(np.mean([r["ms"] for r in v["vs_plain"]["views"]]))
                                                for k, v in native_runs.items()},
        "scoring_s": fusion["true_depth"]["scoring_s"],
        "overall": fusion["true_depth"]["score"]["overall"],
        "overall_native": fusion["true_depth_native"]["score"]["overall"],
        "tnt_peak_memory_bytes": tnt["peak_memory_bytes"],
    }
    entry = native_kernel_entry({k: v["vs_plain"] for k, v in native_runs.items()},
                                {k: v["launches"] for k, v in native_runs.items()})
    shutil.rmtree(work, ignore_errors=True)
    return summary, entry


# --- Phase 7: the training side --------------------------------------------

# Two processes on the one card at batch 1 each, against one at batch 2
# on the same samples: one warm-up step and DDP_STEPS timed ones, Adam, in
# full float32 arithmetic (TF32 off: its rounding would swamp the float32
# comparison), so their ms are not phase 5's arithmetic.
DDP_STEPS = 3
# The parameter updates (end minus start) of the two runs per group of
# GRAD_GROUPS, as cosines. The runs differ in the order of the batch
# statistics' sums (each process's mean, then their mean), in cuDNN's
# algorithms for batch 1 and 2 and in K4's atomics, and Adam's first steps
# move each element by about lr * sign(g): elements whose gradient is
# near zero flip. Witnesses: the one-process run repeated (atomics only)
# and with its DCN outputs nudged by one step of the activation type
# (``nudged_dcn_outputs``: rounding); the fault it must catch, in float32:
# the two processes with BatchNorm on their local batches
# (``local_batchnorm``). On an NVIDIA H100 80GB HBM3 at 700 W the lowest
# group (FeatureNet) read, float32: 0.968-0.969 (witnesses: repeated
# 0.998, nudged 0.987; the fault 0.888); bf16: 0.808 (repeated 0.944,
# nudged 0.804). bf16's gate sits at its rounding floor, below the float32
# fault, so only the float32 run tells global from local BatchNorm.
DDP_UPDATE_COSINE_MIN = {"float32": 0.95, "bfloat16": 0.7}
TRAIN_SIDE_NVIEWS = 5
DTU_TRAIN_REFS = 2  # reference viewpoints of the DTU tree; 7 lights each
BLENDED_HW, BLENDED_VIEWS = (576, 768), 5
PNG_REPEATS = 3


def split_samples(batch: dict) -> list[dict]:
    """A stacked batch of numpy arrays as its samples."""
    def pick(v, i):
        return {k: pick(x, i) for k, x in v.items()} if isinstance(v, dict) else v[i]

    return [pick(batch, i) for i in range(len(batch["imgs"]))]


def train_on_samples(dev, dtype_name: str, batch_size: int, shard_id: int, num_shards: int,
                     perturb=None) -> dict:
    """The DTU recipe (512x640, 5 views, 48/32/8, Adam) from phase 5's
    seeded weights on ``example_train_batch`` split into samples, as the
    training CLI runs it: this process's shard of the samples at
    ``batch_size``, the model wrapped by ``replicate`` (DDP in a process
    group). One warm-up step, then DDP_STEPS timed ones with the launches
    counted; ``perturb(model)``, if given, is a context the steps run in.
    Returns the shard, the parameters before and after (on the CPU),
    losses, ms per step and launches."""
    import time

    from transmvsnet_tpu_torch.config import ModelConfig
    from transmvsnet_tpu_torch.data.example import example_train_batch
    from transmvsnet_tpu_torch.data.loader import ShardedLoader
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.parallel.sharding import replicate, unwrap
    from transmvsnet_tpu_torch.train.loop import to_device_batch
    from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
    from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

    samples = split_samples(example_train_batch(B=2 * (1 + DDP_STEPS), V=TRAIN_SIDE_NVIEWS, H=TRAIN_H,
                                                W=TRAIN_W, num_hyp=NUM_HYP))
    loader = ShardedLoader(samples, batch_size, num_shards=num_shards, shard_id=shard_id, num_workers=0)
    model = TransMVSNet(ModelConfig(ndepths=NDEPTHS, compute_dtype=dtype_name), device=dev,
                        generator=torch.Generator().manual_seed(0))
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    state = TrainState(replicate(model),
                       *make_optimizer(model.parameters(), warmup_multistep(1e-3, [10**6], 0.5)))
    step = make_train_step()
    batches = [to_device_batch(b, dev) for b in loader]
    losses = []
    with perturb(model) if perturb else contextlib.nullcontext():
        for i, batch in enumerate(batches):
            if i == 1:
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
            _, scalars = step(state, batch)
            losses.append(scalars["loss"].item())
            if scalars["skipped_nan"].item():
                raise AssertionError(f"{dtype_name} shard {shard_id}: a step skipped a non-finite loss: {losses}")
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)
    return {"indices": loader._shard_indices().tolist(), "losses": losses, "ms_per_step": ms,
            "launches": read_launches(), "before": before,
            "after": {n: p.detach().cpu().clone() for n, p in unwrap(state.model).named_parameters()}}


@contextlib.contextmanager
def local_batchnorm(model=None):
    """BatchNorm on each process's local batch, as if it reduced nothing
    across processes: the fault DDP_UPDATE_COSINE_MIN must catch."""
    from transmvsnet_tpu_torch.parallel import distributed

    with patched(distributed, "world_size", lambda _: lambda: 1):
        yield


def ddp_child(argv: list) -> int:
    """One of phase 7's two processes: ``--ddp-child <rank> <host:port>
    <out.pt>``. Joins a gloo group of two on the one card (NCCL refuses two
    ranks on one device) and trains its shard in float32 and in bf16."""
    from transmvsnet_tpu_torch.parallel import distributed

    rank, coordinator, out = int(argv[0]), argv[1], argv[2]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(coordinator, 2, rank, backend="gloo", device="cuda")
    try:
        dev = distributed.process_device("cuda")
        runs = {d: train_on_samples(dev, d, 1, rank, 2) for d in ("float32", "bfloat16")}
        runs["float32_local_batchnorm"] = train_on_samples(dev, "float32", 1, rank, 2, perturb=local_batchnorm)
        torch.save(runs, out)
    finally:
        distributed.shutdown()
    return 0


def spawn(args: list, what: str, timeout: float) -> None:
    """Runs each argument list as ``python3 chip_smoke.py ...`` at once;
    raises unless every process exits 0 within ``timeout`` seconds."""
    import os
    import pathlib

    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    script = str(pathlib.Path(__file__).resolve())
    procs = [subprocess.Popen([sys.executable, script, *a], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True) for a in args]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{what}: process {i} exited {p.returncode}:\n{out[-4000:]}")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def step_and_forward(sfx: str, remat: bool = False) -> dict:
    """Launches per train step plus one validation forward: an epoch of the
    training CLI whose validation set is its training set, per step."""
    train, fwd = STEP_LAUNCHES["train" + sfx + ("_remat" if remat else "")], FORWARD_LAUNCHES["inference" + sfx]
    return {k: train.get(k, 0) + fwd.get(k, 0) for k in {**train, **fwd}}


def update_cosines(a: dict, b: dict) -> dict:
    return group_cosines({n: a["after"][n] - a["before"][n] for n in a["after"]},
                         {n: b["after"][n] - b["before"][n] for n in b["after"]})


def two_processes_on_one_card(dev, work, paths: dict) -> dict:
    """(1) The DTU recipe in two processes of batch 1 on the one card (gloo
    with CUDA tensors) against one process at batch 2 on the same samples,
    float32 and bf16."""
    torch.cuda.empty_cache()
    port = free_port()
    outs = [str(work / f"ddp_{r}.pt") for r in range(2)]
    spawn([["--ddp-child", str(r), f"localhost:{port}", outs[r]] for r in range(2)], "two processes", 900)
    ranks = [torch.load(o, weights_only=False) for o in outs]
    result = {}
    for dtype_name, sfx in (("float32", "_f32"), ("bfloat16", "")):
        what = f"two processes ({dtype_name})"
        r0, r1 = ranks[0][dtype_name], ranks[1][dtype_name]
        if set(r0["indices"]) & set(r1["indices"]):
            raise AssertionError(f"{what}: shards overlap: {r0['indices']} {r1['indices']}")
        equal = all(torch.equal(r0["after"][n], r1["after"][n]) for n in r0["after"])
        for r in (r0, r1):
            expect_launches(r["launches"], STEP_LAUNCHES["train" + sfx], DDP_STEPS, what)
        ref = train_on_samples(dev, dtype_name, 2, 0, 1)
        repeat = train_on_samples(dev, dtype_name, 2, 0, 1)
        nudged = train_on_samples(dev, dtype_name, 2, 0, 1, perturb=lambda m: nudged_dcn_outputs(m, seed=2))
        cos = update_cosines(r0, ref)
        entry = {
            "shards": [r0["indices"], r1["indices"]],
            "ranks_bitwise_equal": equal,
            "ms_per_step_2x1": [r0["ms_per_step"], r1["ms_per_step"]],
            "ms_per_step_1x2": ref["ms_per_step"],
            "phase5_ms_per_step_1x2": paths["train" + sfx]["ms_per_step"],
            "launches_per_step_per_process": {k: v / DDP_STEPS for k, v in r0["launches"].items() if v},
            "losses_2x1_mean_of_ranks": [(a + b) / 2 for a, b in zip(r0["losses"], r1["losses"])],
            "losses_1x2": ref["losses"],
            "update_cosine_vs_1x2": cos,
            "update_cosine_witness_1x2_repeated": update_cosines(repeat, ref),
            "update_cosine_witness_1x2_nudged": update_cosines(nudged, ref),
            "gate": DDP_UPDATE_COSINE_MIN[dtype_name],
        }
        if dtype_name == "float32":
            fault = ranks[0]["float32_local_batchnorm"]
            entry["update_cosine_fault_local_batchnorm"] = update_cosines(fault, ref)
        print(f"training side, {what}: " + json.dumps(entry), flush=True)
        result[dtype_name] = entry
    for dtype_name, entry in result.items():  # gated once every figure is printed
        what, gate = f"two processes ({dtype_name})", DDP_UPDATE_COSINE_MIN[dtype_name]
        if not entry["ranks_bitwise_equal"]:
            raise AssertionError(f"{what}: parameters differ across the processes")
        low = {g: c for g, c in entry["update_cosine_vs_1x2"].items() if not c >= gate}
        if low:
            raise AssertionError(f"{what}: update cosine against one process at batch 2 below {gate}: {low}")
        fault = entry.get("update_cosine_fault_local_batchnorm")
        if fault and min(fault.values()) >= gate:
            raise AssertionError(f"{what}: the gate misses BatchNorm on local batches: {fault}")
    return result


def cli_with_nccl(dev, work) -> dict:
    """(2) tools/train.py --distributed at world size 1: NCCL on the card
    (there is one card: nothing across cards is measured), with the CLI's
    default remat (the recompute's launches counted)."""
    from transmvsnet_tpu_torch.tools import train

    backends = []

    def record(init):
        def wrapped(backend, *args, **kwargs):
            backends.append(backend)
            return init(backend, *args, **kwargs)
        return wrapped

    reset_launches()
    with patched(torch.distributed, "init_process_group", record):
        with cudnn_default_arithmetic():
            state = train.main(["--distributed", "--coordinator", f"localhost:{free_port()}", "--num_processes", "1",
                                "--process_id", "0", "--dataset", "synthetic", "--nviews", "3", "--numdepth", "48",
                                "--epochs", "1", "--logdir", str(work / "nccl")])
    launches = read_launches()
    out = {"backend": backends, "steps": state.step, "launches": {k: v for k, v in launches.items() if v},
           "checkpoint": (work / "nccl/model_000000.ckpt").exists(),
           "process_group_left": not torch.distributed.is_initialized()}
    print("training side, CLI with NCCL: " + json.dumps(out), flush=True)
    if backends != ["nccl"] or state.step != 2 or not out["checkpoint"] or not out["process_group_left"]:
        raise AssertionError(f"the CLI with NCCL: {out}")
    expect_launches(launches, step_and_forward("_f32", remat=True), 2, "the CLI with NCCL (per step)")
    return out


def write_dtu_train_tree(root) -> None:
    """A seeded DTU training tree (``data/datasets.py::DTUTrainDataset``'s
    layout): one scan of TRAIN_SIDE_NVIEWS viewpoints at 1600x1200, each an
    RGB PNG of Paeth rows (``paeth_png``) linked for all 7 lights, the
    first DTU_TRAIN_REFS as references with a PFM depth map and a grey
    ``depth_visual`` PNG (about half above the mask's 10); the example
    cameras at 1/4 of the 640x512 crop; depth line "425.0 2.5"."""
    import os

    from transmvsnet_tpu_torch.data.cams import write_cam_file
    from transmvsnet_tpu_torch.data.example import example_inputs
    from transmvsnet_tpu_torch.data.image_io import encode_png
    from transmvsnet_tpu_torch.data.pfm import save_pfm

    h, w = DTU_SOURCE_HW
    views = TRAIN_SIDE_NVIEWS
    rng = np.random.RandomState(11)
    for sub in ("Cameras/train", "Rectified/scan1_train", "Depths_raw/scan1"):
        (root / sub).mkdir(parents=True)
    _, projs, _ = example_inputs(B=1, V=views, H=TRAIN_H, W=TRAIN_W)
    lines = [str(DTU_TRAIN_REFS)]
    for v in range(DTU_TRAIN_REFS):
        others = [o for o in range(views) if o != v]
        lines += [str(v), f"{len(others)} " + " ".join(f"{o} {100.0 - i}" for i, o in enumerate(others))]
    (root / "Cameras/pair.txt").write_text("\n".join(lines) + "\n")
    yy, xx = np.mgrid[0:h, 0:w]
    for v in range(views):
        write_cam_file(str(root / f"Cameras/train/{v:0>8}_cam.txt"), projs["stage1"][0, v], depth_line="425.0 2.5")
        base = np.stack([(xx // 3 + 40 * v) % 256, (yy // 2) % 256, ((xx + yy) // 5) % 256], -1)
        img = np.clip(base + rng.randint(-12, 13, base.shape), 0, 255).astype(np.uint8)
        first = root / f"Rectified/scan1_train/rect_{v + 1:0>3}_0_r5000.png"
        first.write_bytes(paeth_png(img))
        for light in range(1, 7):
            os.link(first, root / f"Rectified/scan1_train/rect_{v + 1:0>3}_{light}_r5000.png")
        if v < DTU_TRAIN_REFS:
            depth = 500.0 + 300.0 * yy / h + 20.0 * np.sin(xx / 50.0)
            save_pfm(str(root / f"Depths_raw/scan1/depth_map_{v:0>4}.pfm"), depth.astype(np.float32))
            visual = ((xx + yy + v) % 21).astype(np.uint8)
            (root / f"Depths_raw/scan1/depth_visual_{v:0>4}.png").write_bytes(encode_png(visual))
    (root / "train.txt").write_text("scan1\n")


def dtu_training(dev, work, paths: dict) -> dict:
    """(3) DTU training data through the CLI: every PNG of the tree decoded
    by the compiled unfilter and by ``_unfilter`` (equal bytes), ms per
    1600x1200 PNG by each route, the loader's samples per second with its
    threads, and the CLI's ms per step beside phase 5's model-only step."""
    import time
    import zlib

    from transmvsnet_tpu_torch.data import image_io
    from transmvsnet_tpu_torch.data.datasets import DTUTrainDataset
    from transmvsnet_tpu_torch.data.loader import ShardedLoader
    from transmvsnet_tpu_torch.tools import train

    root = work / "dtu_train"
    t0 = time.perf_counter()
    write_dtu_train_tree(root)
    out = {"tree_s": time.perf_counter() - t0}
    pngs = sorted(root.glob("Rectified/scan1_train/rect_*_0_r5000.png")) + sorted(root.glob("Depths_raw/*/*.png"))
    views = pngs[:TRAIN_SIDE_NVIEWS]
    equal = True
    for p in pngs:
        data = p.read_bytes()
        equal &= bool(np.array_equal(image_io.decode_png(data, dev), image_io.decode_png(data, "cpu")))
    datas = [p.read_bytes() for p in views]
    t0 = time.perf_counter()
    for _ in range(PNG_REPEATS):
        for d in datas:
            image_io.decode_png(d, dev)
    out["ms_per_png_1600x1200_compiled"] = (time.perf_counter() - t0) * 1e3 / (PNG_REPEATS * len(datas))
    t0 = time.perf_counter()
    for d in datas:
        image_io.decode_png(d, "cpu")
    out["ms_per_png_1600x1200_numpy"] = (time.perf_counter() - t0) * 1e3 / len(datas)
    t0 = time.perf_counter()
    for d in datas:  # the inflate alone, which both routes share (zlib on the host)
        zlib.decompress(d[d.index(b"IDAT") + 4: -16])
    out["ms_per_png_1600x1200_inflate"] = (time.perf_counter() - t0) * 1e3 / len(datas)
    out["png_routes_equal"] = equal
    out["pngs_checked"] = len(pngs)

    lst = str(root / "train.txt")
    dataset = DTUTrainDataset(str(root), lst, nviews=TRAIN_SIDE_NVIEWS, device=dev)
    loader = ShardedLoader(dataset, TRAIN_B, shuffle=True, drop_last=True)
    t0 = time.perf_counter()
    served = sum(len(b["imgs"]) for b in loader)
    out["loader_samples_per_s"] = served / (time.perf_counter() - t0)
    out["loader_threads"] = loader.num_workers

    reset_launches()
    image_io.png_unfilter.launches = 0
    logdir = work / "dtu_logs"
    with cudnn_default_arithmetic():
        state = train.main(["--dataset", "dtu", "--datapath", str(root), "--trainlist", lst, "--testlist", lst,
                            "--nviews", str(TRAIN_SIDE_NVIEWS), "--batch_size", str(TRAIN_B), "--epochs", "1",
                            "--summary_freq", "1", "--no_remat", "--logdir", str(logdir)])
    torch.cuda.synchronize()
    records = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    steps = [r["sec_per_iter"] * 1e3 for r in records if r["mode"] == "train"]
    samples = len(dataset)
    out.update({
        "samples": samples, "steps": state.step, "cli_ms_per_step_after_the_first": steps[1:],
        "cli_ms_per_step": float(np.mean(steps[1:])),
        "phase5_model_only_ms_per_step_f32": paths["train_f32"]["ms_per_step"],
        "png_unfilter_calls": image_io.png_unfilter.launches,
        "launches": {k: v for k, v in read_launches().items() if v},
        "losses_finite": all(np.isfinite(r["loss"]) for r in records),
    })
    print("training side, DTU through the CLI: " + json.dumps(out), flush=True)
    # Six PNGs per sample (five views and the mask), each sample read once
    # by the train epoch and once by the validation epoch.
    if not (equal and out["losses_finite"] and state.step == samples // TRAIN_B
            and out["png_unfilter_calls"] == 2 * 6 * samples):
        raise AssertionError(f"DTU through the CLI: {out}")
    expect_launches(read_launches(), step_and_forward("_f32"), state.step, "DTU through the CLI (per step)")
    return out


def write_blended_tree(dev, root) -> None:
    """A seeded BlendedMVS tree (``BlendedTrainDataset``'s layout): one scan
    of BLENDED_VIEWS views at 768x576, JPEGs written by nvJPEG, "bld" cams
    (the example cameras at full resolution; depth line min, interval,
    count, max) and PFM depths partly outside the range."""
    from transmvsnet_tpu_torch.data.cams import write_cam_file
    from transmvsnet_tpu_torch.data.example import example_inputs
    from transmvsnet_tpu_torch.data.image_io import write_jpeg
    from transmvsnet_tpu_torch.data.pfm import save_pfm

    h, w = BLENDED_HW
    scan = root / "5b7a3890fc8fcf6781e2593a"
    for sub in ("blended_images", "cams", "rendered_depth_maps"):
        (scan / sub).mkdir(parents=True)
    _, projs, _ = example_inputs(B=1, V=BLENDED_VIEWS, H=h, W=w)
    rng = np.random.RandomState(12)
    yy, xx = np.mgrid[0:h, 0:w]
    lines = [str(BLENDED_VIEWS)]
    for v in range(BLENDED_VIEWS):
        others = [o for o in range(BLENDED_VIEWS) if o != v]
        lines += [str(v), f"{len(others)} " + " ".join(f"{o} {100.0 - i}" for i, o in enumerate(others))]
        write_cam_file(str(scan / f"cams/{v:0>8}_cam.txt"), projs["stage3"][0, v],
                       depth_line="425.0 2.637760 192 931.45")
        base = np.stack([(xx // 2 + 30 * v) % 256, (yy // 3) % 256, ((xx - yy) // 4) % 256], -1)
        img = np.clip(base + rng.randint(-10, 11, base.shape), 0, 255).astype(np.uint8)
        write_jpeg(str(scan / f"blended_images/{v:0>8}.jpg"), torch.from_numpy(img).to(dev))
        depth = 400.0 + 560.0 * yy / h + 10.0 * np.cos(xx / 30.0)
        save_pfm(str(scan / f"rendered_depth_maps/{v:0>8}.pfm"), depth.astype(np.float32))
    (scan / "cams/pair.txt").write_text("\n".join(lines) + "\n")
    (root / "list.txt").write_text(scan.name + "\n")


def blended_training(dev, work) -> dict:
    """(4) BlendedMVS through the CLI (--dataset blended --loss bld, 4
    views): the samples read on the card (nvJPEG) against the CPU's (PIL)
    within the codec gate, the other fields equal; a few steps."""
    import time

    from transmvsnet_tpu_torch.data.datasets import BlendedTrainDataset
    from transmvsnet_tpu_torch.tools import train

    root = work / "blended"
    write_blended_tree(dev, root)
    lst = str(root / "list.txt")
    card, cpu = (BlendedTrainDataset(str(root), lst, device=d) for d in (dev, "cpu"))
    worst = {"mean_abs_levels": 0.0, "max_abs_levels": 0}
    same = True
    for i in range(len(card)):
        a, b = card[i], cpu[i]
        d = np.abs(np.round(a["imgs"] * 255).astype(np.int64) - np.round(b["imgs"] * 255).astype(np.int64))
        worst = {"mean_abs_levels": max(worst["mean_abs_levels"], float(d.mean())),
                 "max_abs_levels": max(worst["max_abs_levels"], int(d.max()))}
        same &= all(np.array_equal(a[k][s], b[k][s]) for k in ("proj_matrices", "depth", "mask")
                    for s in ("stage1", "stage2", "stage3"))
        same &= bool(np.array_equal(a["depth_values"], b["depth_values"]) and a["depth_interval"] == b["depth_interval"])
    reset_launches()
    logdir = work / "blended_logs"
    t0 = time.perf_counter()
    with cudnn_default_arithmetic():
        state = train.main(["--dataset", "blended", "--loss", "bld", "--datapath", str(root), "--trainlist", lst,
                            "--testlist", lst, "--nviews", "4", "--batch_size", "1", "--lr", "2e-4", "--epochs", "1",
                            "--summary_freq", "1", "--no_remat", "--logdir", str(logdir)])
    torch.cuda.synchronize()
    records = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    steps = [r["sec_per_iter"] * 1e3 for r in records if r["mode"] == "train"]
    out = {"samples": len(card), "card_vs_cpu_images": worst, "other_fields_equal": same, "steps": state.step,
           "cli_s": time.perf_counter() - t0, "cli_ms_per_step_after_the_first": steps[1:],
           "epe": [r["epe"] for r in records if r["mode"] == "train"],
           "launches": {k: v for k, v in read_launches().items() if v}}
    print("training side, BlendedMVS through the CLI: " + json.dumps(out), flush=True)
    finite = all(np.isfinite(r["loss"]) and np.isfinite(r["epe"]) for r in records)
    if not (same and finite and state.step == len(card)
            and worst["mean_abs_levels"] <= CODEC_MEAN_MAX and worst["max_abs_levels"] <= CODEC_MAX):
        raise AssertionError(f"BlendedMVS through the CLI (codec gate mean <= {CODEC_MEAN_MAX}, "
                             f"max <= {CODEC_MAX} levels): {out}")
    return out


def training_summary(t: dict) -> dict:
    """Phase 7's figures in one line."""
    two = t["two_processes"]
    return {
        "two_processes_ms_per_step_2x1": {d: e["ms_per_step_2x1"] for d, e in two.items()},
        "one_process_ms_per_step_1x2": {d: e["ms_per_step_1x2"] for d, e in two.items()},
        "phase5_ms_per_step_1x2": {d: e["phase5_ms_per_step_1x2"] for d, e in two.items()},
        "update_cosine_vs_1x2_lowest_group": {d: min(e["update_cosine_vs_1x2"].values()) for d, e in two.items()},
        "update_cosine_witness_lowest_group": {d: {w: min(e[f"update_cosine_witness_1x2_{w}"].values())
                                                   for w in ("repeated", "nudged")} for d, e in two.items()},
        "cli_nccl_backend": t["cli_nccl"]["backend"],
        **{k: t["dtu"][k] for k in ("ms_per_png_1600x1200_compiled", "ms_per_png_1600x1200_numpy",
                                    "ms_per_png_1600x1200_inflate", "loader_samples_per_s", "cli_ms_per_step",
                                    "phase5_model_only_ms_per_step_f32")},
        "blended_card_vs_cpu_images": t["blended"]["card_vs_cpu_images"],
        "blended_cli_ms_per_step_after_the_first": t["blended"]["cli_ms_per_step_after_the_first"],
    }


def switches_summary(paths: dict, remat: dict) -> dict:
    """Phases 4-5's two cost regularisation forms and the remat step in
    one line: ms per depth map and per step of each form in turns, each
    form's cost_reg ms per stage, their agreement; the remat step's ms and
    peak memory beside the step without it."""
    from transmvsnet_tpu_torch.config import ModelConfig

    out = {"default_cost_reg": "dense" if ModelConfig().dense_cost_reg else "3d"}
    for sfx in ("", "_f32"):
        inf, step = paths["inference" + sfx], paths["train" + sfx]
        out["inference" + sfx] = {
            "ms_per_depth_map_in_turns": inf["ms_per_depth_map_in_turns_by_cost_reg"],
            "cost_reg_ms_by_stage": {form: {k: v for k, v in parts.items() if k.startswith("cost_reg")}
                                     for form, parts in inf["ms_by_part_by_cost_reg"].items()},
            "other_form_stage3_depth_within_one_interval": inf["other_cost_reg"]["stage3_depth_within_one_interval"],
            "other_form_max_abs_dprob_stage3": inf["other_cost_reg"]["max_abs_dprob"]["stage3"],
            "planted_band_fault": {k: inf["other_cost_reg"]["planted_band_fault"][k]
                                   for k in ("stage3_depth_within_one_interval", "stage3_prob_columns_within_tol")},
        }
        out["train" + sfx] = {
            "ms_per_step_in_turns": step["ms_per_step_in_turns"],
            "other_form_gradient_cosine_lowest_group": min(step["other_cost_reg_gradients"]["cosine"].values()),
        }
    out["per_view_features"] = paths["inference"]["per_view_features"]
    out["remat_f32"] = {k: remat[k] for k in ("ms_per_step", "peak_memory_bytes", "ms_per_step_in_turns")}
    return out


def training_side(dev, paths: dict) -> dict:
    """Phase 7: two processes on the one card, the CLI with NCCL, DTU and
    BlendedMVS training data through the CLI, in a scratch tree under
    build/ (git-ignored)."""
    import pathlib
    import shutil

    work = pathlib.Path(__file__).resolve().parent / "build" / "train_side"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {"two_processes": two_processes_on_one_card(dev, work, paths), "cli_nccl": cli_with_nccl(dev, work),
           "dtu": dtu_training(dev, work, paths), "blended": blended_training(dev, work)}
    shutil.rmtree(work, ignore_errors=True)
    return out


# --- Phase 8: the mesh -----------------------------------------------------

# The (data, view, depth) meshes of ``parallel/mesh.py`` in processes that
# share the one card through gloo (NCCL refuses two ranks on one device),
# started as ``chip_smoke.py --mesh-child``: the DTU recipe (512x640, 5
# views, 48/32/8, float32 with remat: the training CLI's default; Adam;
# batch 1 per data group) at each mesh of MESH_TRAIN, one warm-up and
# MESH_STEPS timed steps, and the DTU-eval forward (1152x864, 5 views,
# batch 1) in bf16 and float32 at MESH_INFER, each against one process on
# the card on the same samples and weights, in full float32 arithmetic
# (TF32 off), as phase 7. Processes sharing one card say nothing about
# speed across cards: their ms are printed as measured, nothing more.
MESH_STEPS = 3
MESH_TRAIN = {2: [(1, 2, 1), (1, 1, 2)], 4: [(1, 2, 2)]}  # processes: meshes
MESH_INFER = (1, 2, 2)
# A mesh sums its reductions in other orders than one process (the view
# sums, PixelwiseNet's statistics, the FMT's KV), and Adam's first steps
# move each element by about lr * sign(g): the float32 gate of phase 7.
# On an NVIDIA H100 80GB HBM3 at 700 W the lowest group (FeatureNet) read
# 0.979-0.981 at the three meshes in two runs, the one process repeated
# (K3's and K4's atomics) 0.989 and 0.998.
MESH_UPDATE_COSINE_MIN = DDP_UPDATE_COSINE_MIN["float32"]
# The forwards against one process, in full float32 arithmetic: float32
# differs in summation order only, so its stage-3 depth (within one
# interval), probability columns and confidence (within DENSE_PROB_TOL of
# the column's spread) are gated as the two cost regularisation forms'
# (DENSE_AGREE_MIN). In bf16 a sum taken in another order (the FMT's KV,
# its GEMMs on half the tokens) rounds to another bf16 value now and then
# and eight FMT layers carry it on, so only the stage-3 depth is gated,
# at bf16's rounding floor, beside the witness of that floor: one process
# with its DCN outputs nudged by one bf16 step (``nudged_dcn_outputs``).
# On an NVIDIA H100 80GB HBM3 at 700 W the mesh read, float32: depth
# 100%, columns 99.9991%, confidence 99.9999%; bf16: depth 97.19%,
# columns 75.6%, confidence 95.4%, the witness 96.90%, 66.6% and 91.0%.
# The processes of a mesh compute the same outputs (bitwise equal in
# that run): their stage-3 depths are held to one another at the same
# gates.
MESH_AGREE_MIN = {"float32": DENSE_AGREE_MIN["float32"], "bfloat16": 0.95}


def mesh_name(shape) -> str:
    return "x".join(map(str, shape))


@contextlib.contextmanager
def recorded_sweeps(calls: list):
    """Each warp-correlation kernel call's (kernel, views, hypotheses, h, w)
    appended to ``calls`` inside the block (the wrappers that
    ``ops/vjp.py`` launches)."""
    from transmvsnet_tpu_torch.ops import vjp

    def record(kernel):
        def wrap(fn):
            def recording(src, ref, src_proj, ref_proj, depth, *args, **kwargs):
                calls.append((kernel, src.shape[1], *depth.shape[1:]))
                return fn(src, ref, src_proj, ref_proj, depth, *args, **kwargs)
            return recording
        return wrap

    with contextlib.ExitStack() as stack:
        for kernel in ("warp_correlate", "warp_correlate_wsum", "warp_correlate_bwd", "warp_correlate_wsum_bwd"):
            stack.enter_context(patched(vjp, kernel, record(kernel)))
        yield


def expected_sweeps(kernels: tuple, ph: int, pw: int) -> list:
    """The (kernel, views, hypotheses, h, w) this process gives the warp
    kernels in one pass on the active mesh: its chunk of the 4 sources and
    its slab of each stage's hypotheses."""
    from transmvsnet_tpu_torch.parallel import sharding

    out = []
    for i, D in enumerate(NDEPTHS):
        scale = 2 ** (2 - i)
        for kernel in kernels:
            out.append((kernel, sharding.chunk(V - 1, "view")[1], sharding.chunk(D, "depth")[1],
                        ph // scale, pw // scale))
    return out


def mesh_train(dev, shape=None) -> dict:
    """The DTU recipe, float32 with remat, batch 1, on this process's share
    of ``shape`` (one process without): parameters before and after, losses,
    ms per step, launches and collectives over the timed steps, the warp
    kernels' shapes in one step, peak memory."""
    import time

    from transmvsnet_tpu_torch.config import MeshConfig, ModelConfig
    from transmvsnet_tpu_torch.data.example import example_train_batch
    from transmvsnet_tpu_torch.data.loader import ShardedLoader
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.parallel import collectives
    from transmvsnet_tpu_torch.parallel.mesh import make_mesh
    from transmvsnet_tpu_torch.parallel.sharding import replicate, sharding_rules, unwrap
    from transmvsnet_tpu_torch.train.loop import to_device_batch
    from transmvsnet_tpu_torch.train.schedule import make_optimizer, warmup_multistep
    from transmvsnet_tpu_torch.train.step import TrainState, make_train_step

    mesh = make_mesh(MeshConfig(*shape) if shape else None)
    samples = split_samples(example_train_batch(B=1 + MESH_STEPS, V=V, H=TRAIN_H, W=TRAIN_W, num_hyp=NUM_HYP))
    batches = [to_device_batch(b, dev) for b in ShardedLoader(samples, 1, num_workers=0)]
    model = TransMVSNet(ModelConfig(ndepths=NDEPTHS, remat=True), device=dev,
                        generator=torch.Generator().manual_seed(0))
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    state = TrainState(replicate(model),
                       *make_optimizer(model.parameters(), warmup_multistep(1e-3, [10**6], 0.5)))
    step = make_train_step()
    losses, sweeps = [], []
    with sharding_rules(mesh):
        for i, batch in enumerate(batches):
            if i == 1:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                collectives.reset()
                t0 = time.perf_counter()
            with recorded_sweeps(sweeps) if i == 0 else contextlib.nullcontext():
                _, scalars = step(state, batch)
            losses.append(scalars["loss"].item())
            if scalars["skipped_nan"].item():
                raise AssertionError(f"mesh {shape}: a step skipped a non-finite loss: {losses}")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / MESH_STEPS
        expected = expected_sweeps(("warp_correlate", "warp_correlate_bwd"), TRAIN_H, TRAIN_W)
    return {"coords": mesh.coords, "losses": losses, "ms_per_step": ms, "launches": read_launches(),
            "collectives": collectives.read(), "sweeps": sweeps, "expected_sweeps": sorted(expected),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(), "before": before,
            "after": {n: p.detach().cpu().clone() for n, p in unwrap(state.model).named_parameters()}}


def mesh_infer(dev, dtype_name: str, shape=None, perturb=None) -> dict:
    """The DTU-eval forward in ``dtype_name`` on this process's share of
    ``shape`` (one process without), on phase 4's weights and inputs:
    REQUESTS forwards, their ms and launches, the warp kernels' shapes in
    one, the collectives of one, and the outputs the agreement reads (on
    the CPU). ``perturb(model)``, if given, is a context the forwards run
    in."""
    import time

    from transmvsnet_tpu_torch.config import MeshConfig, ModelConfig
    from transmvsnet_tpu_torch.data.example import example_inputs
    from transmvsnet_tpu_torch.models.feature_net import DCN
    from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
    from transmvsnet_tpu_torch.parallel import collectives
    from transmvsnet_tpu_torch.parallel.mesh import make_mesh
    from transmvsnet_tpu_torch.parallel.sharding import sharding_rules

    mesh = make_mesh(MeshConfig(*shape) if shape else None)
    gen = torch.Generator().manual_seed(0)
    model = TransMVSNet(ModelConfig(ndepths=NDEPTHS, compute_dtype=dtype_name), device=dev, generator=gen).eval()
    with torch.no_grad():  # as main_path: offsets of about a pixel
        for m in model.modules():
            if isinstance(m, DCN):
                w, b = m.conv_offset_mask.weight, m.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=gen) * 0.05)
                b.copy_(torch.randn(b.shape, generator=gen) * 1.5)
    imgs, projs, dv = example_inputs(B=B, V=V, H=H, W=W, num_hyp=NUM_HYP)
    inputs = (torch.from_numpy(imgs).to(dev), {k: torch.from_numpy(v).to(dev) for k, v in projs.items()},
              torch.from_numpy(dv).to(dev))
    sweeps = []
    with torch.no_grad(), sharding_rules(mesh), perturb(model) if perturb else contextlib.nullcontext():
        with recorded_sweeps(sweeps):
            model(*inputs)
        collectives.reset()
        out = model(*inputs)
        counts = collectives.read()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            model(*inputs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / REQUESTS
        expected = expected_sweeps(("warp_correlate",), H, W)
    keep = {s: {k: out[s][k].cpu() for k in ("prob_volume", "depth", "photo_confidence")}
            for s in ("stage1", "stage2", "stage3")}
    return {"coords": mesh.coords, "ms_per_depth_map": ms, "launches": read_launches(), "collectives": counts,
            "sweeps": sweeps, "expected_sweeps": sorted(expected), "outputs": {**keep, "depth": keep["stage3"]["depth"]}}


def mesh_child(argv: list) -> int:
    """One process of phase 8: ``--mesh-child <rank> <processes> <host:port>
    <out.pt>``. Joins a gloo group on the one card and runs the meshes of
    MESH_TRAIN (and, in four processes, MESH_INFER's forwards)."""
    from transmvsnet_tpu_torch.parallel import distributed

    rank, processes, coordinator, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(coordinator, processes, rank, backend="gloo", device="cuda")
    try:
        dev = distributed.process_device("cuda")
        runs = {}
        for shape in MESH_TRAIN[processes]:
            runs["train_f32_" + mesh_name(shape)] = mesh_train(dev, shape)
            torch.cuda.empty_cache()
        if processes == math.prod(MESH_INFER):
            for dtype_name, sfx in (("bfloat16", ""), ("float32", "_f32")):
                r = mesh_infer(dev, dtype_name, MESH_INFER)
                if rank:  # the stage-3 depth stands for the rest
                    r["outputs"] = {"depth": r["outputs"]["depth"]}
                runs[f"inference{sfx}_{mesh_name(MESH_INFER)}"] = r
                torch.cuda.empty_cache()
        torch.save(runs, out)
    finally:
        distributed.shutdown()
    return 0


def the_mesh(dev, remat: dict) -> dict:
    """Phase 8: each mesh run against one process on the card, the
    processes' outputs in a scratch tree under build/ (git-ignored)."""
    import pathlib
    import shutil

    from transmvsnet_tpu_torch.data.example import DEPTH_MAX, DEPTH_MIN

    work = pathlib.Path(__file__).resolve().parent / "build" / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    runs = {}
    for processes in MESH_TRAIN:
        torch.cuda.empty_cache()
        port = free_port()
        outs = [str(work / f"mesh{processes}_{r}.pt") for r in range(processes)]
        spawn([["--mesh-child", str(r), str(processes), f"localhost:{port}", outs[r]] for r in range(processes)],
              f"the mesh in {processes} processes", 900)
        for r, o in enumerate(outs):
            for name, run in torch.load(o, weights_only=False).items():
                runs.setdefault(name, []).append(run)
    shutil.rmtree(work, ignore_errors=True)
    single = mesh_train(dev)
    repeat = mesh_train(dev)
    result, failures = {}, []
    for name, ranks in runs.items():
        what = f"mesh {name}"
        entry = {"processes": len(ranks), "coords": [r["coords"] for r in ranks]}
        train = name.startswith("train")
        per_pass = STEP_LAUNCHES["train_f32_remat"] if train else FORWARD_LAUNCHES[name.rsplit("_", 1)[0]]
        for r in ranks:
            try:
                expect_launches(r["launches"], per_pass, MESH_STEPS if train else REQUESTS, f"{what} {r['coords']}")
            except AssertionError as e:
                failures.append(str(e))
            if sorted(r["sweeps"]) != r["expected_sweeps"]:
                failures.append(f"{what} {r['coords']}: warp kernels on {sorted(r['sweeps'])}, "
                                f"the share is {r['expected_sweeps']}")
        entry["launches"] = ranks[0]["launches"]
        entry["launches_per_pass_per_process"] = {k: v / (MESH_STEPS if train else REQUESTS)
                                                  for k, v in ranks[0]["launches"].items() if v}
        entry["warp_shapes_by_process"] = {str(r["coords"]): sorted(r["sweeps"]) for r in ranks}
        entry["collective_bytes_per_pass_per_process"] = {
            k: v / (MESH_STEPS if train else 1) for k, v in ranks[0]["collectives"]["bytes"].items()}
        entry["collective_bytes_by_site"] = {s: {k: c["bytes"] / (MESH_STEPS if train else 1) for k, c in kinds.items()}
                                             for s, kinds in ranks[0]["collectives"]["sites"].items()}
        if train:
            entry["ms_per_step_by_process"] = [r["ms_per_step"] for r in ranks]
            entry["one_process_ms_per_step"] = single["ms_per_step"]
            entry["phase5_remat_ms_per_step_batch2_tf32"] = remat["ms_per_step"]["remat"]
            entry["peak_memory_bytes_by_process"] = [r["peak_memory_bytes"] for r in ranks]
            entry["one_process_peak_memory_bytes"] = single["peak_memory_bytes"]
            entry["ranks_bitwise_equal"] = all(torch.equal(ranks[0]["after"][n], r["after"][n])
                                               for r in ranks[1:] for n in r["after"])
            entry["losses"] = ranks[0]["losses"]
            entry["one_process_losses"] = single["losses"]
            entry["update_cosine_vs_one_process"] = update_cosines(ranks[0], single)
            entry["update_cosine_witness_one_process_repeated"] = update_cosines(repeat, single)
            entry["gate"] = MESH_UPDATE_COSINE_MIN
            if not entry["ranks_bitwise_equal"]:
                failures.append(f"{what}: parameters differ across the processes")
            low = {g: c for g, c in entry["update_cosine_vs_one_process"].items() if not c >= MESH_UPDATE_COSINE_MIN}
            if low:
                failures.append(f"{what}: update cosine against one process below {MESH_UPDATE_COSINE_MIN}: {low}")
        else:
            dtype_name = "float32" if name.startswith("inference_f32") else "bfloat16"
            one = mesh_infer(dev, dtype_name)
            interval = 0.5 * (DEPTH_MAX - DEPTH_MIN) / NUM_HYP

            def agreement(got, want):
                out = form_agreement(got, want, interval, dtype_name)
                spread = want["stage3"]["prob_volume"].amax(1) - want["stage3"]["prob_volume"].amin(1)
                dconf = (got["stage3"]["photo_confidence"] - want["stage3"]["photo_confidence"]).abs()
                out["stage3_confidence_within_tol"] = (dconf <= DENSE_PROB_TOL[dtype_name] * spread).float().mean().item()
                return out

            entry.update(agreement(ranks[0]["outputs"], one["outputs"]))
            if dtype_name == "bfloat16":
                nudged = mesh_infer(dev, dtype_name, perturb=lambda m: nudged_dcn_outputs(m, seed=2))
                entry["witness_one_process_nudged"] = agreement(nudged["outputs"], one["outputs"])
                del nudged
            gate = MESH_AGREE_MIN[dtype_name]
            entry["gate"] = {"agree_min": gate, "prob_tol": DENSE_PROB_TOL[dtype_name]}
            entry["ms_per_depth_map_by_process"] = [r["ms_per_depth_map"] for r in ranks]
            entry["one_process_ms_per_depth_map"] = one["ms_per_depth_map"]
            depth0 = ranks[0]["outputs"]["depth"]
            entry["ranks_stage3_depth_within_one_interval_of_rank0"] = [
                ((r["outputs"]["depth"] - depth0).abs() <= interval).float().mean().item() for r in ranks[1:]]
            entry["ranks_bitwise_equal"] = all(torch.equal(r["outputs"]["depth"], depth0) for r in ranks[1:])
            gated = ["stage3_depth_within_one_interval"]
            if dtype_name == "float32":
                gated += ["stage3_prob_columns_within_tol", "stage3_confidence_within_tol"]
            if not all(entry[k] >= gate for k in gated):
                failures.append(f"{what}: its outputs disagree with one process's: "
                                f"{ {k: entry[k] for k in gated} }")
            if not min(entry["ranks_stage3_depth_within_one_interval_of_rank0"]) >= gate:
                failures.append(f"{what}: the processes' depths differ: "
                                f"{entry['ranks_stage3_depth_within_one_interval_of_rank0']}")
            del one
        print(f"mesh, {name}: " + json.dumps(entry), flush=True)
        result[name] = entry
    if failures:  # raised once every figure is printed
        raise AssertionError("the mesh: " + "; ".join(failures))
    return result


def mesh_summary(mesh: dict) -> dict:
    """Phase 8's figures in one line."""
    out = {}
    for name, e in mesh.items():
        line = {"collective_bytes_per_pass_per_process": e["collective_bytes_per_pass_per_process"]}
        if name.startswith("train"):
            line.update({k: e[k] for k in ("ms_per_step_by_process", "one_process_ms_per_step",
                                            "phase5_remat_ms_per_step_batch2_tf32")})
            line["update_cosine_lowest_group"] = min(e["update_cosine_vs_one_process"].values())
            line["witness_lowest_group"] = min(e["update_cosine_witness_one_process_repeated"].values())
        else:
            line.update({k: e[k] for k in ("ms_per_depth_map_by_process", "one_process_ms_per_depth_map",
                                            "stage3_depth_within_one_interval", "stage3_prob_columns_within_tol",
                                            "stage3_confidence_within_tol")})
            if "witness_one_process_nudged" in e:
                line["witness_stage3_depth_within_one_interval"] = \
                    e["witness_one_process_nudged"]["stage3_depth_within_one_interval"]
        out[name] = line
    return out


def mesh_share_checks(dev, gen) -> dict:
    """K6 and K4 (float32) on the shares of the training meshes, K2 and K6
    on the forward mesh's, and K7 and K8 (bf16, the fused view sum, taken
    when only depth is split) on depth slabs of two at stages 2-3, against
    their plain versions: each share is the last process's chunk of the 4
    sources and its slab of the hypotheses (the tolerances of phase 3).
    Rows by kernel name."""
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
        warp_correlate,
        warp_correlate_plain,
        warp_correlate_wsum,
        warp_correlate_wsum_plain,
    )
    from transmvsnet_tpu_torch.ops.cuda.warp_correlate_bwd import (
        warp_correlate_bwd,
        warp_correlate_bwd_plain,
        warp_correlate_wsum_bwd,
        warp_correlate_wsum_bwd_plain,
    )
    from transmvsnet_tpu_torch.parallel.sharding import chunk_sizes
    from transmvsnet_tpu_torch.tools.compare_dcn import sweep_inputs

    def last(n, parts):
        sizes = chunk_sizes(n, parts)
        return slice(n - sizes[-1], n)

    cases = [("train", 1, TRAIN_H, TRAIN_W, s[1], s[2], torch.float32, ("fwd", "bwd"))
             for shapes in MESH_TRAIN.values() for s in shapes]
    cases += [("inference", B, H, W, MESH_INFER[1], MESH_INFER[2], dt, ("fwd",)) for dt in (torch.bfloat16, torch.float32)]
    cases += [(path, b, ph, pw, 1, 2, torch.bfloat16, ("wsum", "wsum_bwd"))
              for path, (b, ph, pw) in (("train", (1, TRAIN_H, TRAIN_W)), ("inference", (B, H, W)))]
    rows: dict = {}
    for path, b, ph, pw, view, depth, dtype, kinds in cases:
        for i, (stage, C, D) in enumerate(SWEEPS):
            if "wsum" in kinds[0] and i == 0:
                continue  # stage 1 computes the view weights: no fused sum
            src, ref, src_proj, ref_proj, dv = sweep_inputs(gen, dev, b, ph, pw, i, stage, C, D, dtype)
            vs, ds = last(V - 1, view), last(D, depth)
            args = (src[:, vs].contiguous(), ref, src_proj[:, vs].contiguous(), ref_proj, dv[:, ds].contiguous())
            S_l, D_l = args[0].shape[1], args[4].shape[1]
            h, w = args[0].shape[-2:]
            vw = torch.rand(b, S_l, h, w, generator=gen).to(dev)
            for kind in kinds:
                if kind == "fwd":
                    name, got, want = "warp_correlate", warp_correlate(*args), warp_correlate_plain(*args)
                elif kind == "bwd":
                    g = torch.randn(b, S_l, D_l, h, w, generator=gen).to(dev)
                    name, got, want = "warp_correlate_bwd", warp_correlate_bwd(*args, g), warp_correlate_bwd_plain(*args, g)
                elif kind == "wsum":
                    name = "warp_correlate_wsum"
                    got, want = warp_correlate_wsum(*args, vw), warp_correlate_wsum_plain(*args, vw)
                else:
                    g = torch.randn(b, D_l, h, w, generator=gen).to(dev)
                    name = "warp_correlate_wsum_bwd"
                    got = warp_correlate_wsum_bwd(*args, vw, g, need_dvw=False)[:2]
                    want = warp_correlate_wsum_bwd_plain(*args, vw, g, need_dvw=False)[:2]
                name += suffix(dtype) if "wsum" not in kind else ""
                res = check_all(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,),
                                1e-3, 1e-3, f"{name} on the mesh share {path} {stage} (view {view}, depth {depth})")
                rows.setdefault(name, []).append({"path": path, "mesh_view": view, "mesh_depth": depth,
                                                  "shape": [b, S_l, C, D_l, h, w], **res})
                del got, want
            del src, ref, src_proj, ref_proj, dv, args, vw
            torch.cuda.empty_cache()
    for name, r in rows.items():
        print(f"{name} on the mesh shares: worst max_abs_err {max(x['max_abs_err'] for x in r):.3g} over "
              f"{len(r)} shapes", flush=True)
    return rows


def machine_report() -> dict:
    """What the card's machine has for images: the Python image packages,
    and the libnvjpeg the codec loaded (its resolved path)."""
    import importlib.util

    from transmvsnet_tpu_torch.ops.cuda import build

    build.library("image_codec")
    with open("/proc/self/maps") as f:
        nvjpeg = sorted({line.split()[-1] for line in f if "libnvjpeg" in line})
    return {"modules": {m: importlib.util.find_spec(m) is not None for m in ("cv2", "PIL", "torchvision", "imageio")},
            "libnvjpeg": nvjpeg}


def main() -> int:
    if sys.argv[1:2] == ["--ddp-child"]:
        return ddp_child(sys.argv[2:])
    if sys.argv[1:2] == ["--mesh-child"]:
        return mesh_child(sys.argv[2:])
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
    # Comparisons on the card in full float32, not TF32 (the training
    # step's timed run excepted).
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
    print("machine: " + json.dumps(machine_report()), flush=True)

    gen = torch.Generator().manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    kernels = [dcn_checks(dev, gen), warp_checks(dev, gen, bf16), dcn_bwd_checks(dev, gen, bf16),
               warp_bwd_checks(dev, gen, bf16), dcn_given_checks(dev, gen, f32),
               dcn_given_checks(dev, gen, bf16), warp_checks(dev, gen, f32),
               dcn_bwd_checks(dev, gen, f32), warp_bwd_checks(dev, gen, f32),
               wsum_checks(dev, gen), wsum_bwd_checks(dev, gen)]
    paths = {}
    for sfx in PATH_CONFIGS:
        torch.cuda.empty_cache()
        paths["inference" + sfx] = main_path(dev, sfx)
        torch.cuda.empty_cache()
        paths["train" + sfx] = train_path(dev, sfx)
    torch.cuda.empty_cache()
    remat = remat_path(dev)
    torch.cuda.empty_cache()
    pipeline, native_entry = evaluation_pipeline(dev, paths, smi)
    torch.cuda.empty_cache()
    training = training_side(dev, paths)
    torch.cuda.empty_cache()
    shares = mesh_share_checks(dev, gen)
    mesh = the_mesh(dev, remat)
    for k in kernels:
        # Counts over each path's timed run (REQUESTS forwards, TRAIN_STEPS
        # steps); "launches" is the kernel's main path's (0 for row 4's
        # bf16 K5, which no path runs).
        k["launches_by_path"] = {p: r["launches"][k["name"]] for p, r in paths.items()}
        k["launches"] = k["launches_by_path"][k["main_path"]]
        # Phase 8's runs, per process (its process of coordinates 0).
        k["launches_by_path"].update({"mesh_" + n: e["launches"][k["name"]] for n, e in mesh.items()})
        k["mesh_shares"] = shares.get(k["name"], [])
    # The native fuser runs on none of those paths: its launches are phase
    # 6's fusion runs through the CLI.
    kernels.append(native_entry)
    print("evaluation pipeline (" + smi + "): " + json.dumps(pipeline))
    print("training side (" + smi + "): " + json.dumps(training_summary(training)))
    print("cost regularisation and remat (" + smi + "): " + json.dumps(switches_summary(paths, remat)))
    print("the mesh (" + smi + "; processes sharing one card: no figure across cards): "
          + json.dumps(mesh_summary(mesh)))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
