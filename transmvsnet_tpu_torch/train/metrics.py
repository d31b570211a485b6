"""Validation metrics (reference utils.py:155-175), as the JAX package's
``train/metrics.py`` has them.

``thres_metric``: share of valid pixels with |error| > threshold,
computed per image and then averaged over the batch. ``abs_depth_error``:
mean absolute error over valid pixels, per image and then over the batch.
"""

from __future__ import annotations

import torch


def _per_image_masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(values.dtype)
    per_image = (values * m).sum(dim=(1, 2)) / (m.sum(dim=(1, 2))).clamp_min(1e-10)
    return per_image.mean()


def thres_metric(depth_est, depth_gt, mask, thres: float) -> torch.Tensor:
    """[B, H, W] each -> scalar share of valid pixels with |error| > thres."""
    err = (depth_est - depth_gt).abs()
    return _per_image_masked_mean((err > thres).float(), mask)


def abs_depth_error(depth_est, depth_gt, mask, band: tuple[float, float] | None = None) -> torch.Tensor:
    """Mean |error| over valid pixels, optionally only within an error band."""
    err = (depth_est - depth_gt).abs()
    m = mask
    if band is not None:
        m = m & (err >= band[0]) & (err <= band[1])
    return _per_image_masked_mean(err, m)


def standard_eval_metrics(depth_est, depth_gt, mask) -> dict[str, torch.Tensor]:
    """The reference's TensorBoard metric set (reference train.py:170-187)."""
    mask = mask > 0.5
    out = {"abs_depth_error": abs_depth_error(depth_est, depth_gt, mask)}
    for t in (2, 4, 8, 14, 20):
        out[f"thres{t}mm_error"] = thres_metric(depth_est, depth_gt, mask, float(t))
    return out
