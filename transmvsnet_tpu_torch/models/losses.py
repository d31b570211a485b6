"""Training losses: masked cross-entropy over depth bins, per-stage weighting.

The reference losses (reference models/module.py:495-592), as the JAX
package's ``models/losses.py`` has them: ``entropy_loss`` takes the
nearest hypothesis as the ground-truth bin (first index on ties), masks
invalid pixels and averages -log(p[gt bin] + 1e-6) over the valid pixels
of each image; ``cascade_loss`` applies it per stage with entropy weight
2.0 and the per-stage ``dlossw`` weights. Boolean-mask indexing is
written as where/sum reductions, so nothing syncs with the host.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(values.dtype)
    return (values * m).sum() / (m.sum() + 1e-10)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (beta 1), ``F.smooth_l1_loss``'s core."""
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def entropy_loss(
    prob_volume: torch.Tensor,
    depth_gt: torch.Tensor,
    mask: torch.Tensor,
    depth_values: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """prob_volume [B, D, H, W] (softmaxed); depth_gt [B, H, W]; mask
    [B, H, W] boolean; depth_values [B, D] or [B, D, H, W]. Returns
    (scalar loss, winner-take-all depth [B, H, W])."""
    if depth_values.ndim < 3:
        dv_full = depth_values[:, :, None, None].expand_as(prob_volume)
    else:
        dv_full = depth_values.expand_as(prob_volume)
    maskf = mask.float()
    valid_count = maskf.sum(dim=(1, 2)) + 1e-6
    gt_index = torch.argmin((dv_full - depth_gt[:, None]).abs(), dim=1)
    gt_index = torch.where(mask, gt_index, torch.zeros_like(gt_index))
    log_p = torch.log(prob_volume + 1e-6)
    ce = -torch.gather(log_p, 1, gt_index[:, None])[:, 0]
    loss = ((ce * maskf).sum(dim=(1, 2)) / valid_count).mean()
    idx = torch.argmax(prob_volume, dim=1, keepdim=True)
    wta_depth = torch.gather(dv_full, 1, idx)[:, 0]
    return loss, wta_depth


def cascade_loss(
    outputs: Mapping[str, Any],
    depth_gt_ms: Mapping[str, torch.Tensor],
    mask_ms: Mapping[str, torch.Tensor],
    dlossw: Sequence[float] | None = (1.0, 1.0, 1.0),
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """Per-stage weighted entropy loss (reference models/module.py:534-558).

    Returns (total_loss, depth_loss, total_entropy, last stage's WTA depth,
    per-stage scalars). ``depth_loss`` is the last stage's smooth-L1, as the
    reference overwrites it per stage; it carries no gradient into the loss.
    """
    total_loss = 0.0
    total_entropy = 0.0
    depth_loss = torch.zeros(())
    wta = None
    per_stage: dict[str, torch.Tensor] = {}
    for key in sorted(k for k in outputs if k.startswith("stage")):
        stage = outputs[key]
        mask = mask_ms[key] > 0.5
        gt = depth_gt_ms[key]
        entro, wta = entropy_loss(stage["prob_volume"], gt, mask, stage["depth_values"])
        entro = entro * 2.0
        depth_loss = masked_mean(smooth_l1(wta, gt), mask)
        total_entropy = total_entropy + entro
        per_stage[f"entropy_{key}"] = entro
        per_stage[f"depth_loss_{key}"] = depth_loss
        weight = 1.0 if dlossw is None else dlossw[int(key.removeprefix("stage")) - 1]
        total_loss = total_loss + weight * entro
    return total_loss, depth_loss, total_entropy, wta, per_stage
