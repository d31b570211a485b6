"""Visualization helpers: depth colorization and TensorBoard image logging.

The reference colorizes depth maps into 8-bit ranges and writes image
summaries every few steps (reference utils.py:11-21, 98-116); the JAX
package's ``utils_vis.py`` has these helpers, and these are its own copy.
``depth_to_color`` maps through the JET table that ``cv2.applyColorMap``
uses, built here in numpy (the card's machine is not promised cv2).
"""

from __future__ import annotations

import numpy as np


def depth_to_gray(
    depth: np.ndarray, depth_min: float | None = None, depth_max: float | None = None
) -> np.ndarray:
    """Normalize a depth map to uint8 [0, 255] for visualization."""
    depth = np.asarray(depth, dtype=np.float32)
    valid = np.isfinite(depth) & (depth > 0)
    if depth_min is None:
        depth_min = float(depth[valid].min()) if valid.any() else 0.0
    if depth_max is None:
        depth_max = float(depth[valid].max()) if valid.any() else 1.0
    scaled = (np.clip(depth, depth_min, depth_max) - depth_min) / max(depth_max - depth_min, 1e-6)
    return (scaled * 255).astype(np.uint8)


def jet_table() -> np.ndarray:
    """``cv2.COLORMAP_JET`` as RGB uint8 [256, 3]. OpenCV samples Octave's
    jet at 256 points, stores the samples in float32 and interpolates them
    in float32 at its own 256 float32 sample positions before scaling by
    255 and rounding; the same steps here give its table exactly."""
    x = np.linspace(0.0, 1.0, 256)
    rgb = np.stack(
        [np.clip(np.minimum(4 * x - 1.5, 4.5 - 4 * x), 0, 1),
         np.clip(np.minimum(4 * x - 0.5, 3.5 - 4 * x), 0, 1),
         np.clip(np.minimum(4 * x + 0.5, 2.5 - 4 * x), 0, 1)], axis=1
    ).astype(np.float32)
    pos = np.arange(256, dtype=np.float32) * (np.float32(1) / np.float32(255))
    dx = (pos[1:] - pos[:-1])[:, None]
    table = rgb.copy()
    table[1:] = rgb[:-1] + dx * (rgb[1:] - rgb[:-1]) / dx
    return np.clip(np.rint(table * np.float32(255)), 0, 255).astype(np.uint8)


def depth_to_color(
    depth: np.ndarray, depth_min: float | None = None, depth_max: float | None = None
) -> np.ndarray:
    """Colormapped uint8 [H, W, 3] RGB depth visualization (JET)."""
    return jet_table()[depth_to_gray(depth, depth_min, depth_max)]


def error_map(
    depth_est: np.ndarray, depth_gt: np.ndarray, mask: np.ndarray, cap: float = 20.0
) -> np.ndarray:
    """Absolute-error visualization, masked, capped at ``cap`` mm."""
    err = np.abs(np.asarray(depth_est) - np.asarray(depth_gt))
    err = np.where(np.asarray(mask) > 0.5, err, 0.0)
    return (np.clip(err / cap, 0, 1) * 255).astype(np.uint8)


def log_depth_images(writer, mode: str, depth_est, confidence, batch: dict, step: int) -> None:
    """The first image's estimated depth and confidence, and, where the
    batch has ground truth, its depth and error map, as TensorBoard images
    (``writer.add_image``, CHW uint8). Tensors may lie on any device."""

    def first(t) -> np.ndarray:
        return t[0].detach().float().cpu().numpy()

    depth = first(depth_est)
    writer.add_image(f"{mode}/depth_est", depth_to_gray(depth)[None], step)
    writer.add_image(f"{mode}/confidence", (first(confidence) * 255).astype(np.uint8)[None], step)
    if "depth" in batch:
        gt, mask = first(batch["depth"]["stage3"]), first(batch["mask"]["stage3"])
        writer.add_image(f"{mode}/depth_gt", depth_to_gray(gt)[None], step)
        writer.add_image(f"{mode}/error", error_map(depth, gt, mask)[None], step)
