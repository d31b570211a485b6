"""Warp-correlation backward: CUDA kernels ``csrc/warp_correlate_bwd.cu``
and their plain versions.

``warp_correlate_bwd`` (K4) replaces the TPU kernel ``transmvsnet_tpu/ops/
pallas/warp_bwd.py::warp_correlate_bwd`` (bf16 features, the kernel's bf16
instantiation); its float32 instantiation is the float32 path's backward,
where the JAX package differentiates the XLA warp.
``warp_correlate_wsum_bwd`` (K8, bf16 features) replaces
``warp_bwd.py::warp_correlate_wsum_bwd``, the gradients of the
view-weighted sum (K7), and the view weights' gradient when asked
(``need_dvw``; K8's instantiation without it skips that work). All S
source views of a batch go through one call, which launches three kernels
in order: a channels-last copy of the source features, the body, and the
planar write of dsrc. Each wrapper allocates the outputs and the body's
scratch, launches its kernels for a CUDA tensor and takes its plain
version only for a CPU tensor; anything the kernels do not take raises.
``warp_correlate_bwd.launches`` counts K4's bf16 instantiation's calls,
``warp_correlate_bwd.launches_f32`` the float32 one's,
``warp_correlate_wsum_bwd.launches`` K8's (both instantiations).
"""

from __future__ import annotations

import ctypes

import torch

from transmvsnet_tpu_torch.ops.cuda import build
from transmvsnet_tpu_torch.ops.cuda.warp_correlate import (
    _check,
    _check_wsum,
    relative_rows,
    warp_correlate_plain,
    warp_correlate_wsum_plain,
)


def _buffers(src, B, S, C, H, W):
    """The outputs dsrc and dref, zeroed (the entry points' contract, which
    an earlier build of them, one that accumulates into its outputs, also
    keeps), and the scratch: src_cl, the source features channels-last in
    their dtype, and acc, the float32 channels-last dsrc sums."""
    dev = src.device
    return (
        torch.zeros((B, S, C, H, W), dtype=torch.float32, device=dev),
        torch.zeros((B, C, H, W), dtype=torch.float32, device=dev),
        torch.empty((B * S, H, W, C), dtype=src.dtype, device=dev),
        torch.empty((B * S, H, W, C), dtype=torch.float32, device=dev),
    )


def warp_correlate_bwd_plain(
    src: torch.Tensor,
    ref: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth: torch.Tensor,
    g: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: autograd of
    ``warp_correlate_plain`` in float32 with respect to the features.
    src [B, S, C, H, W]; ref [B, C, H, W]; fused projections [B, S, 4, 4]
    and [B, 4, 4]; depth [B, D, H, W]; g [B, S, D, H, W]. Returns
    (dsrc, dref), float32."""
    with torch.enable_grad():
        s = src.detach().float().requires_grad_()
        r = ref.detach().float().requires_grad_()
        out = warp_correlate_plain(s, r, src_proj.detach(), ref_proj.detach(), depth.detach())
        return torch.autograd.grad(out, (s, r), g.float())


def warp_correlate_bwd(
    src: torch.Tensor,
    ref: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth: torch.Tensor,
    g: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients (dsrc, dref) of ``warp_correlate``, float32. Arguments as
    ``warp_correlate_bwd_plain``; on CUDA, src and ref must be both float32
    or both bfloat16, and depth float32. Projections and depth get no gradient."""
    if src.device.type == "cpu":
        return warp_correlate_bwd_plain(src, ref, src_proj, ref_proj, depth, g)
    if src.device.type != "cuda":
        raise ValueError(f"warp_correlate_bwd runs on cuda or cpu tensors, got {src.device}")
    B, S, C, D, H, W = _check(src, ref, src_proj, ref_proj, depth)
    if tuple(g.shape) != (B, S, D, H, W) or g.device != src.device:
        raise ValueError(f"g must be [{B}, {S}, {D}, {H}, {W}] on {src.device}, got {tuple(g.shape)}")
    rel = relative_rows(src_proj, ref_proj)
    gf = g.float().contiguous()
    dsrc, dref, src_cl, acc = _buffers(src, B, S, C, H, W)
    lib = build.library("warp_correlate_bwd")
    fn = lib.warp_correlate_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    code = fn(
        src.data_ptr(), ref.data_ptr(), rel.data_ptr(), depth.data_ptr(), gf.data_ptr(),
        dsrc.data_ptr(), dref.data_ptr(), B * S, S, C, D, H, W, int(src.dtype == torch.bfloat16),
        build.stream_handle(src), src_cl.data_ptr(), acc.data_ptr(),
    )
    build.check(lib, "warp_correlate_bwd", code)
    build.count_launch(warp_correlate_bwd, src.dtype)
    return dsrc, dref


warp_correlate_bwd.launches = 0
warp_correlate_bwd.launches_f32 = 0


def warp_correlate_wsum_bwd_plain(
    src: torch.Tensor,
    ref: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth: torch.Tensor,
    vw: torch.Tensor,
    g: torch.Tensor,
    need_dvw: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """K8's function in plain PyTorch: autograd of
    ``warp_correlate_wsum_plain`` in float32 with respect to the features
    and, if ``need_dvw``, the view weights. vw [B, S, H, W]; g [B, D, H, W];
    other arguments as ``warp_correlate_bwd_plain``. Returns (dsrc, dref,
    dvw), float32; dvw is None unless ``need_dvw``."""
    with torch.enable_grad():
        s = src.detach().float().requires_grad_()
        r = ref.detach().float().requires_grad_()
        w = vw.detach().float().requires_grad_(need_dvw)
        out = warp_correlate_wsum_plain(s, r, src_proj.detach(), ref_proj.detach(), depth.detach(), w)
        grads = torch.autograd.grad(out, (s, r, w) if need_dvw else (s, r), g.float())
    return grads if need_dvw else (*grads, None)


def warp_correlate_wsum_bwd(
    src: torch.Tensor,
    ref: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth: torch.Tensor,
    vw: torch.Tensor,
    g: torch.Tensor,
    need_dvw: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Gradients (dsrc, dref, dvw) of ``warp_correlate_wsum``, float32; dvw
    is None unless ``need_dvw``, and then not computed. Arguments as
    ``warp_correlate_wsum_bwd_plain``; on CUDA, src and ref must be
    bfloat16, depth and vw float32. Projections and depth get no
    gradient."""
    if src.device.type == "cpu":
        return warp_correlate_wsum_bwd_plain(src, ref, src_proj, ref_proj, depth, vw, g, need_dvw)
    if src.device.type != "cuda":
        raise ValueError(f"warp_correlate_wsum_bwd runs on cuda or cpu tensors, got {src.device}")
    B, S, C, D, H, W = _check_wsum(src, ref, src_proj, ref_proj, depth, vw)
    if tuple(g.shape) != (B, D, H, W) or g.device != src.device:
        raise ValueError(f"g must be [{B}, {D}, {H}, {W}] on {src.device}, got {tuple(g.shape)}")
    rel = relative_rows(src_proj, ref_proj)
    gf = g.float().contiguous()
    dsrc, dref, src_cl, acc = _buffers(src, B, S, C, H, W)
    # Passed even when not asked for: an earlier build of the entry point
    # always writes it.
    dvw = torch.empty((B, S, H, W), dtype=torch.float32, device=src.device)
    lib = build.library("warp_correlate_bwd")
    fn = lib.warp_correlate_wsum_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    code = fn(
        src.data_ptr(), ref.data_ptr(), rel.data_ptr(), depth.data_ptr(), vw.data_ptr(),
        gf.data_ptr(), dsrc.data_ptr(), dref.data_ptr(), dvw.data_ptr(), B * S, S, C, D, H, W,
        build.stream_handle(src), src_cl.data_ptr(), acc.data_ptr(), int(need_dvw),
    )
    build.check(lib, "warp_correlate_bwd", code)
    build.count_launch(warp_correlate_wsum_bwd, src.dtype)
    return dsrc, dref, dvw if need_dvw else None


warp_correlate_wsum_bwd.launches = 0
