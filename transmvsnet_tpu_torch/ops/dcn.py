"""Modulated deformable convolution (DCNv2), plain PyTorch, NCHW.

The reference's ``torchvision.ops.deform_conv2d`` use (reference
models/dcn.py:55-80): a 3x3 offset/mask conv gives 27 channels read in
torchvision's interleaved layout, dy_k = off[2k], dx_k = off[2k+1],
mask_k = sigmoid(off[18 + k]); each tap samples bilinearly with zeros
padding, is scaled by its mask and contracted with a tap-major weight.
This is the CPU path and the oracle for the CUDA kernels in
``ops/cuda/dcn_fused.py`` and ``ops/cuda/dcn.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from transmvsnet_tpu_torch.ops.sampling import bilinear_gather


def offset_conv(x: torch.Tensor, k_off: torch.Tensor, b_off: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W], k_off [3K, C, 3, 3] (torch layout), b_off [3K]
    -> [B, 3K, H, W], 3x3 stride 1 pad 1, in x's dtype."""
    return F.conv2d(x, k_off.to(x.dtype), b_off.to(x.dtype), padding=1)


def split_offsets(off: torch.Tensor):
    """[B, 3K, H, W] -> (dy, dx, mask), each [B, K, H, W]."""
    K = off.shape[1] // 3
    cat = off[:, : 2 * K]
    return cat[:, 0::2], cat[:, 1::2], torch.sigmoid(off[:, 2 * K :])


def deform_conv2d(
    x: torch.Tensor,
    offset_y: torch.Tensor,
    offset_x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """x [B, C, H, W]; offsets and mask [B, K, Ho, Wo]; weight [K, C, C_out]
    tap-major; bias [C_out]. Accumulates in float32 and returns
    [B, C_out, Ho, Wo] in x's dtype (bias added after the cast, as the JAX
    package's ``deform_conv2d`` does)."""
    B, C, H, W = x.shape
    K, Ho, Wo = offset_y.shape[1:]
    kw = int(round(K**0.5))
    assert kw * kw == K, "square kernels only"
    dev = x.device
    gy = (torch.arange(Ho, dtype=torch.float32, device=dev) * stride - padding)[:, None]
    gx = (torch.arange(Wo, dtype=torch.float32, device=dev) * stride - padding)[None, :]
    out = torch.zeros(B, weight.shape[-1], Ho * Wo, dtype=torch.float32, device=dev)
    for k in range(K):
        i, j = divmod(k, kw)
        py = (gy + i * dilation + offset_y[:, k]).reshape(B, -1)
        px = (gx + j * dilation + offset_x[:, k]).reshape(B, -1)
        sampled = bilinear_gather(x, px, py) * mask[:, k].reshape(B, 1, -1).to(x.dtype)
        out += torch.einsum("bcm,co->bom", sampled.float(), weight[k].float())
    out = out.reshape(B, -1, Ho, Wo).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)[:, None, None]
    return out
