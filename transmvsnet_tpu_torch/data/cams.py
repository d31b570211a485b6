"""Camera-file and pair-file IO for evaluation scans (numpy only).

The MVSNet cam-txt format: 'extrinsic' + 4x4 on lines 1-4, 'intrinsic' +
3x3 on lines 7-9, and a depth line (line 11). Evaluation cams carry
full-resolution intrinsics (divided by 4 here: the model's stage-1
convention) and a depth line (depth_min, depth_interval[, num_depth[,
depth_max]]); a 3-or-more-token line re-derives the interval from
(min, num, interval) (reference datasets/general_eval.py:66-99).
``cv2`` is imported inside the function that resizes images.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CameraInfo:
    intrinsics: np.ndarray  # [3, 3]
    extrinsics: np.ndarray  # [4, 4]
    depth_min: float
    depth_interval: float

    def proj_pair(self) -> np.ndarray:
        """Stack into the model's [2, 4, 4] (extrinsics, homogeneous-K) pair."""
        pair = np.zeros((2, 4, 4), dtype=np.float32)
        pair[0] = self.extrinsics
        pair[1, :3, :3] = self.intrinsics
        return pair


def read_cam_file(path: str, interval_scale: float = 1.0, ndepths: int = 192) -> CameraInfo:
    """An evaluation cam file, intrinsics scaled to stage-1 resolution."""
    with open(path) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extr = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intr = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    intr[:2, :] /= 4.0
    tokens = lines[11].split()
    depth_min = float(tokens[0])
    depth_interval = float(tokens[1])
    if len(tokens) >= 3:
        depth_max = depth_min + int(float(tokens[2])) * depth_interval
        depth_interval = (depth_max - depth_min) / ndepths
    return CameraInfo(intr, extr, depth_min, depth_interval * interval_scale)


def read_pair_file(path: str) -> list[tuple[int, list[int]]]:
    """[(ref_view, [src views sorted by score]), ...]; empty-src entries dropped."""
    data = []
    with open(path) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref_view = int(f.readline().rstrip())
            src_views = [int(x) for x in f.readline().rstrip().split()[1::2]]
            if src_views:
                data.append((ref_view, src_views))
    return data


def write_cam_file(path: str, proj_pair: np.ndarray, depth_line: str = "") -> None:
    """Write the [2, 4, 4] pair back to MVSNet cam-txt format."""
    extr, intr = proj_pair[0], proj_pair[1, :3, :3]
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in extr:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        f.write("\nintrinsic\n")
        for row in intr:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        f.write("\n" + depth_line + "\n")


def scale_mvs_input(
    img: np.ndarray, intrinsics: np.ndarray, max_w: int, max_h: int, base: int = 32
) -> tuple[np.ndarray, np.ndarray]:
    """Resize to fit (max_h, max_w), snapped down to multiples of ``base``,
    rescaling intrinsics (reference general_eval.py:114-131)."""
    import cv2

    h, w = img.shape[:2]
    if h > max_h or w > max_w:
        scale = 1.0 * max_h / h
        if scale * w > max_w:
            scale = 1.0 * max_w / w
        new_w, new_h = scale * w // base * base, scale * h // base * base
    else:
        new_w, new_h = 1.0 * w // base * base, 1.0 * h // base * base

    intrinsics = intrinsics.copy()
    intrinsics[0, :] *= 1.0 * new_w / w
    intrinsics[1, :] *= 1.0 * new_h / h
    img = cv2.resize(img, (int(new_w), int(new_h)))
    return img, intrinsics
