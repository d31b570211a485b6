"""Fused DCNv2 forward: CUDA kernel ``csrc/dcn_fused.cu`` and its plain version.

Replaces the TPU kernel ``transmvsnet_tpu/ops/pallas/dcn_onehot.py::
deform_conv2d_onehot_fused``. ``dcn_fused`` launches the kernel for a CUDA
tensor and takes ``dcn_fused_plain`` only for a CPU tensor; anything the
kernel does not take raises. ``dcn_fused.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from transmvsnet_tpu_torch.ops.cuda import build
from transmvsnet_tpu_torch.ops.dcn import deform_conv2d, offset_conv, split_offsets

SUPPORTED_CHANNELS = (8, 16, 32)


def dcn_fused_plain(
    x: torch.Tensor,
    k_off: torch.Tensor,
    b_off: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, computed in float32 and
    returned in x's dtype. x [B, C, H, W]; k_off [27, C, 3, 3]; b_off [27];
    weight [9, C, C_out] tap-major; bias [C_out]."""
    xf = x.float()
    dy, dx, mask = split_offsets(offset_conv(xf, k_off.float(), b_off.float()))
    return deform_conv2d(xf, dy, dx, mask, weight.float(), bias.float()).to(x.dtype)


def _check(x, k_off, b_off, weight, bias) -> tuple[int, int, int, int, int]:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"dcn_fused kernel takes bfloat16 activations, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"dcn_fused needs a contiguous [B, C, H, W] tensor, got {tuple(x.shape)}")
    B, C, H, W = x.shape
    if weight.ndim != 3 or weight.shape[:2] != (9, C):
        raise ValueError(f"weight must be [9, {C}, C_out], got {tuple(weight.shape)}")
    C_out = weight.shape[2]
    if C not in SUPPORTED_CHANNELS or C_out not in SUPPORTED_CHANNELS:
        raise ValueError(f"dcn_fused kernel takes C, C_out in {SUPPORTED_CHANNELS}, got {C}, {C_out}")
    if tuple(k_off.shape) != (27, C, 3, 3) or tuple(b_off.shape) != (27,):
        raise ValueError(f"offset conv must be [27, {C}, 3, 3] + [27], got {tuple(k_off.shape)}")
    if tuple(bias.shape) != (C_out,):
        raise ValueError(f"bias must be [{C_out}], got {tuple(bias.shape)}")
    for t in (k_off, b_off, weight, bias):
        if t.device != x.device:
            raise ValueError(f"dcn_fused: parameters on {t.device}, activations on {x.device}")
    if B * H * W >= 2**31:
        raise ValueError("dcn_fused: B*H*W must fit in 32 bits")
    return B, C, H, W, C_out


def dcn_fused(
    x: torch.Tensor,
    k_off: torch.Tensor,
    b_off: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """DCNv2, 3x3, stride 1, pad 1, one deformable group, with its offset/
    mask conv inside. Arguments as ``dcn_fused_plain``; on CUDA, x must be
    bfloat16. Returns [B, C_out, H, W] in x's dtype."""
    if x.device.type == "cpu":
        return dcn_fused_plain(x, k_off, b_off, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_fused runs on cuda or cpu tensors, got {x.device}")
    B, C, H, W, C_out = _check(x, k_off, b_off, weight, bias)
    # Weight rows ordered (tap, c) to match the kernel's loops.
    woff = k_off.float().permute(2, 3, 1, 0).reshape(9 * C, 27).contiguous()
    w = weight.float().reshape(9 * C, C_out).contiguous()
    boff = b_off.float().contiguous()
    b = bias.float().contiguous()
    out = torch.empty((B, C_out, H, W), dtype=x.dtype, device=x.device)
    lib = build.library("dcn_fused")
    fn = lib.dcn_fused_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    code = fn(
        x.data_ptr(), woff.data_ptr(), boff.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), B, C, C_out, H, W, build.stream_handle(x),
    )
    build.check(lib, "dcn_fused", code)
    dcn_fused.launches += 1
    return out


dcn_fused.launches = 0
