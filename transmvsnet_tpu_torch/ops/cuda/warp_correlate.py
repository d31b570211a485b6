"""Warp-correlation forward: CUDA kernels ``csrc/warp_correlate.cu`` and
their plain versions.

``warp_correlate`` replaces the TPU kernels ``transmvsnet_tpu/ops/pallas/
warp_onehot.py::warp_correlate_onehot`` (bf16 features: the kernel's bf16
instantiation, K2) and ``warp_rowsweep.py::warp_correlate_rowsweep``
(float32 features: its float instantiation, K6). ``warp_correlate_wsum``
replaces ``warp_onehot.py::warp_correlate_wsum_onehot`` (bf16 features,
K7): the view-weighted sum over the source views, without the per-view
volume. All S source views of a batch go through one call, which launches
two kernels: a channels-last copy of the source features into scratch that
the wrapper allocates (``forward_scratch``), then the body (K2/K6's and
K7's share a lane group's round; K7's lanes each sum the views of a chunk
of hypotheses of a pixel in registers). Each wrapper launches its kernels
for a CUDA tensor and takes its plain version only for a CPU tensor;
anything the kernels do not take raises.
``warp_correlate.launches`` counts K2's calls,
``warp_correlate.launches_f32`` K6's, ``warp_correlate_wsum.launches``
K7's.
"""

from __future__ import annotations

import ctypes

import torch

from transmvsnet_tpu_torch.ops import warp
from transmvsnet_tpu_torch.ops.cuda import build
from transmvsnet_tpu_torch.ops.geometry import relative_projection

SUPPORTED_CHANNELS = (8, 16, 32)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
# K2/K6's C entry point: src, ref, rel, depth, out; N, S, C, D, H, W, bf16;
# the stream; the scratch src_cl. A build before the scratch ignores it.
FORWARD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
# K7's: src, ref, rel, depth, vw, out; B, S, C, D, H, W; the stream; the
# scratch src_cl, which a build before it ignores.
WSUM_FORWARD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2


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
    """What the forward and backward kernels take (each has a float32 and a
    bf16 instantiation); returns (B, S, C, D, H, W)."""
    if src.dtype not in SUPPORTED_DTYPES or ref.dtype != src.dtype:
        raise TypeError(
            "warp_correlate kernel takes float32 or bfloat16 features of one dtype, "
            f"got {src.dtype}, {ref.dtype}"
        )
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


def relative_rows(src_proj: torch.Tensor, ref_proj: torch.Tensor) -> torch.Tensor:
    """The kernels' [B*S, 3, 4] float32 rows of P_src @ P_ref^-1."""
    B, S = src_proj.shape[:2]
    ref_b = ref_proj.float()[:, None].expand(B, S, 4, 4)
    return relative_projection(src_proj.float(), ref_b)[..., :3, :].contiguous()


def warp_correlate(
    src: torch.Tensor,
    ref: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth: torch.Tensor,
) -> torch.Tensor:
    """Arguments as ``warp_correlate_plain``; on CUDA, src and ref must be
    both float32 or both bfloat16, and depth float32. Returns
    [B, S, D, H, W] float32. The CUDA result has no gradient, so with grad
    mode on, features that require one raise;
    ``ops.vjp.warp_correlate_with_vjp`` is the differentiable call."""
    if src.device.type == "cpu":
        return warp_correlate_plain(src, ref, src_proj, ref_proj, depth)
    if src.device.type != "cuda":
        raise ValueError(f"warp_correlate runs on cuda or cpu tensors, got {src.device}")
    if torch.is_grad_enabled() and (src.requires_grad or ref.requires_grad):
        raise RuntimeError(
            "warp_correlate's kernel output has no gradient: call it under torch.no_grad() "
            "or through ops.vjp.warp_correlate_with_vjp"
        )
    B, S, C, D, H, W = _check(src, ref, src_proj, ref_proj, depth)
    rel = relative_rows(src_proj, ref_proj)
    out = torch.empty((B, S, D, H, W), dtype=torch.float32, device=src.device)
    src_cl = forward_scratch(src)
    lib = build.library("warp_correlate")
    code = launch_forward(lib, src, ref, rel, depth, out, src_cl, build.stream_handle(src))
    build.check(lib, "warp_correlate", code)
    build.count_launch(warp_correlate, src.dtype)
    return out


def forward_scratch(src: torch.Tensor) -> torch.Tensor:
    """K2/K6's and K7's scratch for src [B, S, C, H, W]: the source features
    channels-last in their dtype, [records, C], each view's H*W records
    between pads of W + 1 records (the kernel zeroes them), so that every
    corner of a sample lies in bounds. Raises where the body's 32-bit
    indices would overflow, or where a record is not 16-byte aligned."""
    B, S, C, H, W = src.shape
    records = B * S * (H * W + W + 1) + W + 1
    if records * C >= 2**31:
        raise ValueError("warp_correlate: the channels-last copy's B*S*(H*W + W + 1)*C must fit in 32 bits")
    src_cl = torch.empty((records, C), dtype=src.dtype, device=src.device)
    if src_cl.data_ptr() % 16 or (C * src_cl.element_size()) % 16:
        raise ValueError("warp_correlate: the channels-last scratch needs 16-byte records")
    return src_cl


def launch_forward(lib, src, ref, rel, depth, out, src_cl, stream) -> int:
    """Call K2/K6's C entry point of ``lib`` on contiguous tensors (src
    [B, S, C, H, W], depth [B, D, H, W]); returns its error code."""
    B, S, C, H, W = src.shape
    fn = lib.warp_correlate_forward
    fn.restype = ctypes.c_int
    fn.argtypes = FORWARD_ARGTYPES
    return fn(
        src.data_ptr(), ref.data_ptr(), rel.data_ptr(), depth.data_ptr(), out.data_ptr(),
        B * S, S, C, depth.shape[1], H, W, int(src.dtype == torch.bfloat16), stream, src_cl.data_ptr(),
    )


warp_correlate.launches = 0
warp_correlate.launches_f32 = 0


def warp_correlate_wsum_plain(
    src: torch.Tensor,
    ref: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth: torch.Tensor,
    vw: torch.Tensor,
) -> torch.Tensor:
    """K7's function in plain PyTorch, computed in float32: the per-view
    similarity weighted by vw [B, S, H, W] and summed over the views.
    Other arguments as ``warp_correlate_plain``. Returns [B, D, H, W]."""
    sim = warp_correlate_plain(src, ref, src_proj, ref_proj, depth)
    return (sim * vw.float()[:, :, None]).sum(1)


def _check_wsum(src, ref, src_proj, ref_proj, depth, vw) -> tuple[int, int, int, int, int, int]:
    """What K7 and K8 take: ``_check``'s, bf16 features only, and float32
    view weights [B, S, H, W]; returns (B, S, C, D, H, W)."""
    B, S, C, D, H, W = _check(src, ref, src_proj, ref_proj, depth)
    if src.dtype != torch.bfloat16:
        raise TypeError(f"warp_correlate_wsum kernels take bfloat16 features, got {src.dtype}")
    if vw.dtype != torch.float32:
        raise TypeError(f"warp_correlate_wsum kernels take float32 view weights, got {vw.dtype}")
    if tuple(vw.shape) != (B, S, H, W):
        raise ValueError(f"view weights must be [{B}, {S}, {H}, {W}], got {tuple(vw.shape)}")
    if not vw.is_contiguous():
        raise ValueError("warp_correlate_wsum needs contiguous view weights")
    if vw.device != src.device:
        raise ValueError(f"warp_correlate_wsum: inputs on {vw.device} and {src.device}")
    return B, S, C, D, H, W


def warp_correlate_wsum(
    src: torch.Tensor,
    ref: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth: torch.Tensor,
    vw: torch.Tensor,
) -> torch.Tensor:
    """Arguments as ``warp_correlate_wsum_plain``; on CUDA, src and ref must
    be bfloat16, depth and vw float32. Returns [B, D, H, W] float32. The
    CUDA result has no gradient, so with grad mode on, inputs that require
    one raise; ``ops.vjp.warp_correlate_wsum_with_vjp`` is the
    differentiable call."""
    if src.device.type == "cpu":
        return warp_correlate_wsum_plain(src, ref, src_proj, ref_proj, depth, vw)
    if src.device.type != "cuda":
        raise ValueError(f"warp_correlate_wsum runs on cuda or cpu tensors, got {src.device}")
    if torch.is_grad_enabled() and (src.requires_grad or ref.requires_grad or vw.requires_grad):
        raise RuntimeError(
            "warp_correlate_wsum's kernel output has no gradient: call it under torch.no_grad() "
            "or through ops.vjp.warp_correlate_wsum_with_vjp"
        )
    B, S, C, D, H, W = _check_wsum(src, ref, src_proj, ref_proj, depth, vw)
    rel = relative_rows(src_proj, ref_proj)
    out = torch.empty((B, D, H, W), dtype=torch.float32, device=src.device)
    src_cl = forward_scratch(src)
    lib = build.library("warp_correlate")
    code = launch_wsum_forward(lib, src, ref, rel, depth, vw, out, src_cl, build.stream_handle(src))
    build.check(lib, "warp_correlate", code)
    build.count_launch(warp_correlate_wsum, src.dtype)
    return out


def launch_wsum_forward(lib, src, ref, rel, depth, vw, out, src_cl, stream) -> int:
    """Call K7's C entry point of ``lib`` on contiguous tensors (src
    [B, S, C, H, W], depth [B, D, H, W], src_cl from ``forward_scratch``);
    returns its error code."""
    B, S, C, H, W = src.shape
    fn = lib.warp_correlate_wsum_forward
    fn.restype = ctypes.c_int
    fn.argtypes = WSUM_FORWARD_ARGTYPES
    return fn(
        src.data_ptr(), ref.data_ptr(), rel.data_ptr(), depth.data_ptr(), vw.data_ptr(),
        out.data_ptr(), B, S, C, depth.shape[1], H, W, stream, src_cl.data_ptr(),
    )


warp_correlate_wsum.launches = 0
