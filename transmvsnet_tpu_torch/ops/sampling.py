"""Image sampling primitives, NCHW.

- ``bilinear_sample``: ``F.grid_sample(mode='bilinear', padding_mode='zeros',
  align_corners=True)`` in pixel coordinates; each out-of-range corner
  contributes zero.
- ``resize_bilinear``: ``F.interpolate(mode='bilinear',
  align_corners=False)``, half-pixel centres, no antialias.
- ``upsample_nearest_2x``: ``F.interpolate(scale_factor=2, mode='nearest')``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_gather(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``src`` [B, C, H, W] at pixel coords ``x``, ``y``
    [B, M]. Returns [B, C, M] in ``src``'s dtype, weights applied in the
    same dtype; an out-of-range corner contributes zero."""
    B, C, H, W = src.shape
    flat = src.reshape(B, C, H * W)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0).to(src.dtype)
    wy = (y - y0).to(src.dtype)
    # Clamp before the int cast: the invalid-z marker is far out of range.
    x0i = x0.clamp(-2, W + 1).to(torch.int64)
    y0i = y0.clamp(-2, H + 1).to(torch.int64)
    out = None
    for dy, wgt_y in ((0, 1 - wy), (1, wy)):
        yi = y0i + dy
        for dx, wgt_x in ((0, 1 - wx), (1, wx)):
            xi = x0i + dx
            ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
            v = torch.gather(flat, 2, idx[:, None, :].expand(B, C, idx.shape[1]))
            term = v * (wgt_x * wgt_y * ok.to(src.dtype))[:, None, :]
            out = term if out is None else out + term
    return out


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img [B, C, H, W]; x, y [B, ...] pixel coords. Returns [B, C, ...]."""
    B = img.shape[0]
    out = bilinear_gather(img, x.reshape(B, -1), y.reshape(B, -1))
    return out.reshape(B, img.shape[1], *x.shape[1:])


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """x [B, C, H, W] -> [B, C, *out_hw]."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = in[..., i // 2, j // 2]; x [B, C, H, W]."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
