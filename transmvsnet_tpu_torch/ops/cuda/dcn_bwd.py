"""DCNv2 backward: CUDA kernel ``csrc/dcn_bwd.cu`` and its plain version.

Replaces the TPU kernel ``transmvsnet_tpu/ops/pallas/dcn_bwd.py::
deform_conv2d_bwd`` (bf16 activations, the kernel's bf16 instantiation);
its float32 instantiation is the float32 path's backward, where the JAX
package differentiates the XLA sampler. ``dcn_bwd`` launches the kernel
for a CUDA tensor and takes ``dcn_bwd_plain`` only for a CPU tensor;
anything the kernel does not take raises. ``dcn_bwd.launches`` counts the
bf16 instantiation's launches, ``dcn_bwd.launches_f32`` the float32 one's.
"""

from __future__ import annotations

import ctypes

import torch

from transmvsnet_tpu_torch.ops.cuda import build
from transmvsnet_tpu_torch.ops.dcn import deform_conv2d

SUPPORTED_CHANNELS = (8, 16, 32)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def dcn_bwd_plain(
    x: torch.Tensor,
    offset_y: torch.Tensor,
    offset_x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    g: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """The kernel's function in plain PyTorch: autograd of
    ``ops/dcn.py::deform_conv2d`` (no bias) in float32, whose floor-based
    sampler gives the two-tap offset gradient. x [N, C, H, W]; offsets and
    mask [N, 9, H, W]; weight [9, C, C_out] tap-major; g [N, C_out, H, W].
    Returns (dx, d_offset_y, d_offset_x, d_mask, d_weight), float32."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in (x, offset_y, offset_x, mask, weight)]
        out = deform_conv2d(*leaves)
        return torch.autograd.grad(out, leaves, g.float())


def _check(x, offset_y, offset_x, mask, weight, g) -> tuple[int, int, int, int, int]:
    if x.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"dcn_bwd kernel takes float32 or bfloat16 activations, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"dcn_bwd needs x [N, C, H, W], got {tuple(x.shape)}")
    N, C, H, W = x.shape
    if weight.ndim != 3 or weight.shape[:2] != (9, C):
        raise ValueError(f"weight must be [9, {C}, C_out], got {tuple(weight.shape)}")
    C_out = weight.shape[2]
    if C not in SUPPORTED_CHANNELS or C_out not in SUPPORTED_CHANNELS:
        raise ValueError(f"dcn_bwd kernel takes C, C_out in {SUPPORTED_CHANNELS}, got {C}, {C_out}")
    for name, t in (("offset_y", offset_y), ("offset_x", offset_x), ("mask", mask)):
        if tuple(t.shape) != (N, 9, H, W):
            raise ValueError(f"{name} must be [{N}, 9, {H}, {W}], got {tuple(t.shape)}")
    if tuple(g.shape) != (N, C_out, H, W):
        raise ValueError(f"g must be [{N}, {C_out}, {H}, {W}], got {tuple(g.shape)}")
    for t in (offset_y, offset_x, mask, weight, g):
        if t.device != x.device:
            raise ValueError(f"dcn_bwd: inputs on {t.device} and {x.device}")
    if N * C * H * W >= 2**31:
        raise ValueError("dcn_bwd: N*C*H*W must fit in 32 bits")
    return N, C, H, W, C_out


def dcn_bwd(
    x: torch.Tensor,
    offset_y: torch.Tensor,
    offset_x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    g: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Gradients (dx, d_offset_y, d_offset_x, d_mask, d_weight) of the
    deformable 3x3 conv (stride 1, pad 1), all float32. Arguments as
    ``dcn_bwd_plain``; on CUDA, x must be float32 or bfloat16. The bias
    gradient is a plain sum of g, left to the caller."""
    if x.device.type == "cpu":
        return dcn_bwd_plain(x, offset_y, offset_x, mask, weight, g)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_bwd runs on cuda or cpu tensors, got {x.device}")
    N, C, H, W, C_out = _check(x, offset_y, offset_x, mask, weight, g)
    x = x.contiguous()
    dy, dxo, m, gf = (t.float().contiguous() for t in (offset_y, offset_x, mask, g))
    w = weight.float().reshape(9 * C, C_out).contiguous()
    dx_s = torch.zeros((N, C, H, W), dtype=torch.float32, device=x.device)
    ddy, ddx, dm = (torch.empty((N, 9, H, W), dtype=torch.float32, device=x.device) for _ in range(3))
    dw = torch.zeros((9 * C, C_out), dtype=torch.float32, device=x.device)
    lib = build.library("dcn_bwd")
    fn = lib.dcn_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    code = fn(
        x.data_ptr(), dy.data_ptr(), dxo.data_ptr(), m.data_ptr(), w.data_ptr(), gf.data_ptr(),
        dx_s.data_ptr(), ddy.data_ptr(), ddx.data_ptr(), dm.data_ptr(), dw.data_ptr(),
        N, C, C_out, H, W, int(x.dtype == torch.bfloat16), build.stream_handle(x),
    )
    build.check(lib, "dcn_bwd", code)
    build.count_launch(dcn_bwd, x.dtype)
    return dx_s, ddy, ddx, dm, dw.reshape(9, C, C_out)


dcn_bwd.launches = 0
dcn_bwd.launches_f32 = 0
