"""The native fuser's consistency test for one reference view: CUDA kernel
``csrc/native_fuse.cu``.

Replaces no TPU kernel: it is the per-pixel loop of the C++ binary
``native/fuser/fuser.cpp`` (:296-346), the role of the reference's CUDA
fusibile, which the JAX package runs on the CPU. ``native_fuse`` launches
the kernel for CUDA tensors and takes its plain version ``ops/native_fuse.py::
native_fuse_view_plain`` only for CPU tensors; anything the kernel does not
take raises. ``native_fuse.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from transmvsnet_tpu_torch.ops.cuda import build
from transmvsnet_tpu_torch.ops.native_fuse import CAM_FLOATS, native_fuse_view_plain

# The C entry point: depths, offsets, sizes, cams; ref, H, W; srcs, fbs; S;
# min_depth, max_depth, disp_threshold; count, xyz, the stream.
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
            + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3)


def _check(depths, offsets, sizes, cams, ref, ref_hw, srcs, fbs) -> None:
    expect = ((depths, torch.float32, 1), (offsets, torch.int64, 1), (sizes, torch.int32, 2),
              (cams, torch.float32, 2), (srcs, torch.int32, 1), (fbs, torch.float32, 1))
    for name, (t, dtype, ndim) in zip(("depths", "offsets", "sizes", "cams", "srcs", "fbs"), expect):
        if t.dtype != dtype or t.ndim != ndim:
            raise ValueError(f"native_fuse: {name} must be {dtype} with {ndim} dims, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != depths.device:
            raise ValueError(f"native_fuse: inputs on {t.device} and {depths.device}")
    views = offsets.shape[0]
    if tuple(sizes.shape) != (views, 2) or tuple(cams.shape) != (views, CAM_FLOATS):
        raise ValueError(f"native_fuse: sizes must be [{views}, 2] and cams [{views}, {CAM_FLOATS}], got "
                         f"{tuple(sizes.shape)}, {tuple(cams.shape)}")
    if srcs.shape != fbs.shape:
        raise ValueError(f"native_fuse: srcs {tuple(srcs.shape)} and fbs {tuple(fbs.shape)} differ")
    if not 0 <= ref < views:
        raise ValueError(f"native_fuse: reference {ref} outside the {views} views")
    h, w = ref_hw
    if h * w >= 2**31:
        raise ValueError("native_fuse: the reference's H*W must fit in 32 bits")


def native_fuse(
    depths: torch.Tensor,
    offsets: torch.Tensor,
    sizes: torch.Tensor,
    cams: torch.Tensor,
    ref: int,
    ref_hw: tuple[int, int],
    srcs: torch.Tensor,
    fbs: torch.Tensor,
    min_depth: float,
    max_depth: float,
    disp_threshold: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every pixel of reference view ``ref`` against its sources.

    depths: float32 [sum h*w], every view's depth map row-major, one after
    another; offsets int64 [V], view v's first element; sizes int32 [V, 2],
    its (h, w); cams float32 [V, 30] (``CAM_FLOATS``); ref_hw the
    reference's (h, w), on the host so that the launch waits for nothing;
    srcs int32 [S], the loaded sources in order, and fbs float32 [S], each
    source's fx times its camera centre's distance from the reference's.
    Returns (count int32 [h, w]: 1 + the agreeing sources, 0 where the
    depth is rejected; xyz float32 [h, w, 3], the mean of the agreeing
    surface points, 0 where rejected)."""
    if depths.device.type == "cpu":
        return native_fuse_view_plain(depths, offsets, sizes, cams, ref, ref_hw, srcs, fbs, min_depth,
                                      max_depth, disp_threshold)
    if depths.device.type != "cuda":
        raise ValueError(f"native_fuse runs on cuda or cpu tensors, got {depths.device}")
    _check(depths, offsets, sizes, cams, ref, ref_hw, srcs, fbs)
    tensors = [t.contiguous() for t in (depths, offsets, sizes, cams, srcs, fbs)]
    h, w = ref_hw
    count = torch.empty((h, w), dtype=torch.int32, device=depths.device)
    xyz = torch.empty((h, w, 3), dtype=torch.float32, device=depths.device)
    lib = build.library("native_fuse")
    with torch.cuda.device(depths.device):
        code = launch(lib, *tensors, ref, ref_hw, min_depth, max_depth, disp_threshold, count, xyz,
                      build.stream_handle(depths))
    build.check(lib, "native_fuse", code)
    native_fuse.launches += 1
    return count, xyz


def launch(lib, depths, offsets, sizes, cams, srcs, fbs, ref, ref_hw, min_depth, max_depth, disp_threshold,
           count, xyz, stream) -> int:
    """Call the C entry point of ``lib`` on contiguous tensors as
    ``native_fuse`` takes them, into count and xyz; returns its error
    code."""
    fn = lib.native_fuse_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    h, w = ref_hw
    return fn(depths.data_ptr(), offsets.data_ptr(), sizes.data_ptr(), cams.data_ptr(), ref, h, w,
              srcs.data_ptr(), fbs.data_ptr(), srcs.numel(), min_depth, max_depth, disp_threshold,
              count.data_ptr(), xyz.data_ptr(), stream)


native_fuse.launches = 0
