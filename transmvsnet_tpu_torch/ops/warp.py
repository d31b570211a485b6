"""Plane-sweep warp-correlation, plain PyTorch, NCHW.

The reference's homography warp (reference models/module.py:284-322,
grid_sample with zeros padding and align_corners=True) fused with the
pair-wise correlation mean_C(warped_src * ref) (reference
models/TransMVSNet.py:79-80). No gradient flows to the coordinates. This
is the CPU path and the oracle for the CUDA kernel in
``ops/cuda/warp_correlate.py``.
"""

from __future__ import annotations

import torch

from transmvsnet_tpu_torch.ops.geometry import warp_coords
from transmvsnet_tpu_torch.ops.sampling import bilinear_gather


def warp_correlate(
    src_fea: torch.Tensor,
    ref_fea: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth_values: torch.Tensor,
) -> torch.Tensor:
    """src_fea, ref_fea [B, C, H, W]; fused projections [B, 4, 4]; depth
    [B, D, H, W] -> similarity [B, D, H, W] float32.

    Samples in the features' dtype, reduces over C in float32; one depth
    plane at a time, so no [B, C, D, H, W] volume is held.
    """
    B, C, H, W = src_fea.shape
    D = depth_values.shape[1]
    ref_flat = ref_fea.reshape(B, C, H * W)
    out = torch.empty(B, D, H * W, dtype=torch.float32, device=src_fea.device)
    for d in range(D):
        x, y = warp_coords(src_proj, ref_proj, depth_values[:, d : d + 1])
        g = bilinear_gather(
            src_fea, x.detach().reshape(B, -1), y.detach().reshape(B, -1)
        )
        out[:, d] = (g * ref_flat).float().mean(1)
    return out.reshape(B, D, H, W)
