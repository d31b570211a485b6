"""Plane-sweep geometry (reference models/module.py:284-322, 606-634).

A camera is a pair (extrinsics 4x4, intrinsics in a 4x4) stacked as
``proj[..., 2, 4, 4]``. ``fuse_projection`` composes it into one 4x4
P = [[K @ E[:3, :4]], e4]. ``warp_coords`` gives the source-view pixel
coordinates of every (ref pixel, depth hypothesis); points with source
z < 1e-6 go far out of range so a zeros-padded sampler drops them.
``refine_depth_samples`` is the reference's upsample -> window ->
trilinear-resize chain collapsed into two bilinear resizes of the centre
depth map plus per-slice constant offsets (the chain is affine in it).
"""

from __future__ import annotations

import torch

from transmvsnet_tpu_torch.ops.sampling import resize_bilinear

INVALID_COORD = -1.0e6


def fuse_projection(proj: torch.Tensor) -> torch.Tensor:
    """[..., 2, 4, 4] (extrinsics, intrinsics) -> [..., 4, 4]."""
    ext = proj[..., 0, :, :]
    intr = proj[..., 1, :3, :3]
    return torch.cat([intr @ ext[..., :3, :], ext[..., 3:4, :]], dim=-2)


def invert_fused_projection(proj: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [[M, p], [0, 1]] via the adjugate of M, whose
    columns are the cross products of M's rows. A dozen small operations,
    all on the device (the kernel wrappers call this on every launch)."""
    r0, r1, r2 = proj[..., 0, :3], proj[..., 1, :3], proj[..., 2, :3]
    adj = torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0), torch.linalg.cross(r0, r1)], dim=-1)
    det = (r0 * adj[..., :, 0]).sum(-1)
    Minv = adj * (1.0 / det)[..., None, None]
    top = torch.cat([Minv, -(Minv @ proj[..., :3, 3:4])], dim=-1)
    out = torch.nn.functional.pad(top, (0, 0, 0, 1))
    out[..., 3, 3] = 1.0
    return out


def relative_projection(src_proj: torch.Tensor, ref_proj: torch.Tensor) -> torch.Tensor:
    """P_src @ P_ref^-1 for fused projections, [..., 4, 4]."""
    return src_proj @ invert_fused_projection(ref_proj)


def warp_coords(
    src_proj: torch.Tensor, ref_proj: torch.Tensor, depth_values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source pixel coords (x, y), each [B, D, H, W], for fused [B, 4, 4]
    projections and depth hypotheses [B, D, H, W]."""
    B, D, H, W = depth_values.shape
    proj = relative_projection(src_proj, ref_proj)
    rot, trans = proj[:, :3, :3], proj[:, :3, 3]
    dev = depth_values.device
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    pix = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, H * W)
    base = rot @ pix  # [B, 3, N]
    xyz = base[:, :, None, :] * depth_values.reshape(B, 1, D, H * W) + trans[
        :, :, None, None
    ]
    z = xyz[:, 2]
    invalid = z < 1e-6
    safe_z = torch.where(invalid, torch.ones_like(z), z)
    x = torch.where(invalid, INVALID_COORD, xyz[:, 0] / safe_z)
    y = torch.where(invalid, INVALID_COORD, xyz[:, 1] / safe_z)
    return x.reshape(B, D, H, W), y.reshape(B, D, H, W)


def initial_depth_samples(
    depth_hypotheses: torch.Tensor, ndepth: int, stage_hw: tuple[int, int]
) -> torch.Tensor:
    """[B, Dh] dataset sweep -> [B, ndepth, h, w] linspace over its range."""
    h, w = stage_hw
    dmin, dmax = depth_hypotheses[:, 0], depth_hypotheses[:, -1]
    step = (dmax - dmin) / (ndepth - 1)
    d = torch.arange(ndepth, dtype=depth_hypotheses.dtype, device=depth_hypotheses.device)
    samples = dmin[:, None] + d[None, :] * step[:, None]
    return samples[:, :, None, None].expand(samples.shape[0], ndepth, h, w)


def refine_depth_samples(
    prev_depth: torch.Tensor,
    ndepth: int,
    interval: torch.Tensor | float,
    stage_hw: tuple[int, int],
    full_hw: tuple[int, int],
) -> torch.Tensor:
    """Window of ``ndepth`` samples around the upsampled previous depth.

    prev_depth [B, h_prev, w_prev] (the caller detaches it); ``interval`` a
    scalar or [B]. Returns [B, ndepth, h, w].
    """
    cur = resize_bilinear(prev_depth[:, None], full_hw)
    cur = resize_bilinear(cur, stage_hw)[:, 0]
    d = torch.arange(ndepth, dtype=cur.dtype, device=cur.device)
    base = d * (ndepth / (ndepth - 1)) - ndepth / 2
    interval = torch.as_tensor(interval, dtype=cur.dtype, device=cur.device)
    offsets = interval[..., None] * base  # [D] or [B, D]
    return cur[:, None] + offsets[..., :, None, None]
