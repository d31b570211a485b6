"""DCNv2 forward with given offsets and mask: CUDA kernel ``csrc/dcn.cu``
and its plain version.

Replaces the TPU kernels ``transmvsnet_tpu/ops/pallas/dcn_rowsweep.py::
deform_conv2d_rowsweep`` (float32, the kernel's float instantiation) and
``dcn_onehot.py::deform_conv2d_onehot`` (bfloat16 activations, its bf16
instantiation). ``deform_conv2d`` launches the kernel for a CUDA tensor and
takes ``deform_conv2d_plain`` only for a CPU tensor; anything the kernel
does not take raises. ``deform_conv2d.launches`` counts the bf16
instantiation's launches, ``deform_conv2d.launches_f32`` the float32 one's.
"""

from __future__ import annotations

import ctypes

import torch

from transmvsnet_tpu_torch.ops import dcn
from transmvsnet_tpu_torch.ops.cuda import build

SUPPORTED_CHANNELS = (8, 16, 32)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
MAX_SIDE = 32766  # the kernel packs a sample's floor corner into 16-bit halves


def deform_conv2d_plain(
    x: torch.Tensor,
    offset_y: torch.Tensor,
    offset_x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``ops/dcn.py::deform_conv2d``
    computed in float32 and rounded once to x's dtype. For float32 x that
    is ``deform_conv2d`` itself; for bf16 it is row 4's rounding (bias added
    in float32 before the cast), where ``deform_conv2d`` on bf16 would
    round the samples and add the bias after the cast, as the JAX XLA op
    does. x [B, C, H, W]; offsets and mask [B, 9, H, W]; weight [9, C, C_out]
    tap-major; bias [C_out]."""
    return dcn.deform_conv2d(
        x.float(), offset_y.float(), offset_x.float(), mask.float(), weight.float(), bias.float()
    ).to(x.dtype)


def _check(x, offset_y, offset_x, mask, weight, bias) -> tuple[int, int, int, int, int]:
    if x.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"dcn kernel takes float32 or bfloat16 activations, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"dcn needs x [N, C, H, W], got {tuple(x.shape)}")
    N, C, H, W = x.shape
    if weight.ndim != 3 or weight.shape[:2] != (9, C):
        raise ValueError(f"weight must be [9, {C}, C_out], got {tuple(weight.shape)}")
    C_out = weight.shape[2]
    if C not in SUPPORTED_CHANNELS or C_out not in SUPPORTED_CHANNELS:
        raise ValueError(f"dcn kernel takes C, C_out in {SUPPORTED_CHANNELS}, got {C}, {C_out}")
    for name, t in (("offset_y", offset_y), ("offset_x", offset_x), ("mask", mask)):
        if tuple(t.shape) != (N, 9, H, W):
            raise ValueError(f"{name} must be [{N}, 9, {H}, {W}], got {tuple(t.shape)}")
    if tuple(bias.shape) != (C_out,):
        raise ValueError(f"bias must be [{C_out}], got {tuple(bias.shape)}")
    for t in (offset_y, offset_x, mask, weight, bias):
        if t.device != x.device:
            raise ValueError(f"dcn: inputs on {t.device} and {x.device}")
    if N * C * H * W >= 2**31:
        raise ValueError("dcn: N*C*H*W must fit in 32 bits")
    if max(H, W) > MAX_SIDE:
        raise ValueError(f"dcn kernel takes H, W <= {MAX_SIDE}, got {H}, {W}")
    return N, C, H, W, C_out


def deform_conv2d(
    x: torch.Tensor,
    offset_y: torch.Tensor,
    offset_x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """DCNv2, 3x3, stride 1, pad 1, one deformable group, with the offsets
    and mask given. Arguments as ``deform_conv2d_plain``; on CUDA, x must be
    float32 or bfloat16. Returns [N, C_out, H, W] in x's dtype. The CUDA
    result has no gradient, so with grad mode on, inputs that require one
    raise; ``ops.vjp.dcn_with_vjp`` is the differentiable call."""
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offset_y, offset_x, mask, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"dcn runs on cuda or cpu tensors, got {x.device}")
    args = (x, offset_y, offset_x, mask, weight, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError(
            "dcn's kernel output has no gradient: call it under torch.no_grad() "
            "or through ops.vjp.dcn_with_vjp"
        )
    N, C, H, W, C_out = _check(*args)
    x = x.contiguous()
    dy, dx, m = (t.float().contiguous() for t in (offset_y, offset_x, mask))
    w = weight.float().reshape(9 * C, C_out).contiguous()
    b = bias.float().contiguous()
    out = torch.empty((N, C_out, H, W), dtype=x.dtype, device=x.device)
    lib = build.library("dcn")
    fn = lib.dcn_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    bf16 = x.dtype == torch.bfloat16
    code = fn(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), m.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), N, C, C_out, H, W, int(bf16), build.stream_handle(x),
    )
    build.check(lib, "dcn", code)
    build.count_launch(deform_conv2d, x.dtype)
    return out


deform_conv2d.launches = 0
deform_conv2d.launches_f32 = 0
