"""Warp-correlation forward: CUDA kernel ``csrc/warp_correlate.cu`` and its
plain version.

Replaces the TPU kernel ``transmvsnet_tpu/ops/pallas/warp_onehot.py::
warp_correlate_onehot``. All S source views of a batch go through one
launch. ``warp_correlate`` launches the kernel for a CUDA tensor and takes
``warp_correlate_plain`` only for a CPU tensor; anything the kernel does
not take raises. ``warp_correlate.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from transmvsnet_tpu_torch.ops import warp
from transmvsnet_tpu_torch.ops.cuda import build
from transmvsnet_tpu_torch.ops.geometry import relative_projection

SUPPORTED_CHANNELS = (8, 16, 32)


def _flat_views(src, ref, src_proj, ref_proj, depth):
    B, S = src.shape[:2]
    rest = depth.shape[1:]
    return (
        src.reshape(B * S, *src.shape[2:]),
        ref[:, None].expand(B, S, *ref.shape[1:]).reshape(B * S, *ref.shape[1:]),
        src_proj.reshape(B * S, 4, 4),
        ref_proj[:, None].expand(B, S, 4, 4).reshape(B * S, 4, 4),
        depth[:, None].expand(B, S, *rest).reshape(B * S, *rest),
    )


def warp_correlate_plain(
    src: torch.Tensor,
    ref: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth: torch.Tensor,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, computed in float32.

    src [B, S, C, H, W]; ref [B, C, H, W]; fused projections src [B, S, 4, 4]
    and ref [B, 4, 4]; depth [B, D, H, W]. Returns [B, S, D, H, W] float32.
    """
    B, S = src.shape[:2]
    flat = _flat_views(src.float(), ref.float(), src_proj.float(), ref_proj.float(), depth.float())
    sim = warp.warp_correlate(*flat)
    return sim.reshape(B, S, *sim.shape[1:])


def _check(src, ref, src_proj, ref_proj, depth) -> tuple[int, int, int, int, int, int]:
    if src.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
        raise TypeError(f"warp_correlate kernel takes bfloat16 features, got {src.dtype}, {ref.dtype}")
    if depth.dtype != torch.float32:
        raise TypeError(f"warp_correlate kernel takes float32 depth, got {depth.dtype}")
    if src.ndim != 5 or ref.ndim != 4 or depth.ndim != 4:
        raise ValueError("warp_correlate needs src [B, S, C, H, W], ref [B, C, H, W], depth [B, D, H, W]")
    B, S, C, H, W = src.shape
    D = depth.shape[1]
    if tuple(ref.shape) != (B, C, H, W) or tuple(depth.shape) != (B, D, H, W):
        raise ValueError(
            f"shape mismatch: src {tuple(src.shape)}, ref {tuple(ref.shape)}, depth {tuple(depth.shape)}"
        )
    if tuple(src_proj.shape) != (B, S, 4, 4) or tuple(ref_proj.shape) != (B, 4, 4):
        raise ValueError("projections must be [B, S, 4, 4] and [B, 4, 4]")
    if C not in SUPPORTED_CHANNELS:
        raise ValueError(f"warp_correlate kernel takes C in {SUPPORTED_CHANNELS}, got {C}")
    if not (src.is_contiguous() and ref.is_contiguous() and depth.is_contiguous()):
        raise ValueError("warp_correlate needs contiguous src, ref and depth")
    for t in (ref, src_proj, ref_proj, depth):
        if t.device != src.device:
            raise ValueError(f"warp_correlate: inputs on {t.device} and {src.device}")
    if B * S * D * H * W >= 2**31:
        raise ValueError("warp_correlate: B*S*D*H*W must fit in 32 bits")
    return B, S, C, D, H, W


def warp_correlate(
    src: torch.Tensor,
    ref: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth: torch.Tensor,
) -> torch.Tensor:
    """Arguments as ``warp_correlate_plain``; on CUDA, src and ref must be
    bfloat16 and depth float32. Returns [B, S, D, H, W] float32."""
    if src.device.type == "cpu":
        return warp_correlate_plain(src, ref, src_proj, ref_proj, depth)
    if src.device.type != "cuda":
        raise ValueError(f"warp_correlate runs on cuda or cpu tensors, got {src.device}")
    B, S, C, D, H, W = _check(src, ref, src_proj, ref_proj, depth)
    ref_b = ref_proj.float()[:, None].expand(B, S, 4, 4)
    rel = relative_projection(src_proj.float(), ref_b)[..., :3, :].contiguous()
    out = torch.empty((B, S, D, H, W), dtype=torch.float32, device=src.device)
    lib = build.library("warp_correlate")
    fn = lib.warp_correlate_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    code = fn(
        src.data_ptr(), ref.data_ptr(), rel.data_ptr(), depth.data_ptr(), out.data_ptr(),
        B * S, S, C, D, H, W, build.stream_handle(src),
    )
    build.check(lib, "warp_correlate", code)
    warp_correlate.launches += 1
    return out


warp_correlate.launches = 0
