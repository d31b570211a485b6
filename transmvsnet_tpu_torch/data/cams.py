"""Camera-file and pair-file IO (numpy), and the input resize that
rescales the intrinsics with the image.

The MVSNet cam-txt format: 'extrinsic' + 4x4 on lines 1-4, 'intrinsic' +
3x3 on lines 7-9, and a depth line (line 11), read per convention
(reference datasets/dtu_yao.py:53-67, general_eval.py:66-99,
tnt_eval.py:69-83):

- "eval": full-resolution intrinsics (divided by 4 here: the model's
  stage-1 convention) and a depth line (depth_min, depth_interval[,
  num_depth[, depth_max]]); a 3-or-more-token line re-derives the interval
  from (min, num, interval).
- "dtu_train": (depth_min, depth_interval); intrinsics already at 1/4
  resolution.
- "minmax" (Tanks and Temples): full-resolution intrinsics (/4 here) and
  (depth_min, depth_max); the interval is (max - min) / ndepths, not
  scaled.
- "bld" (BlendedMVS, reference datasets/bld_train.py): as "minmax", but
  depth_max is the line's last token (the line may hold more).

"eval" and "dtu_train" scale the interval by ``interval_scale``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from transmvsnet_tpu_torch.data.image_io import resize_bilinear


@dataclasses.dataclass
class CameraInfo:
    intrinsics: np.ndarray  # [3, 3]
    extrinsics: np.ndarray  # [4, 4]
    depth_min: float
    depth_interval: float
    depth_max: float | None = None

    def proj_pair(self) -> np.ndarray:
        """Stack into the model's [2, 4, 4] (extrinsics, homogeneous-K) pair."""
        pair = np.zeros((2, 4, 4), dtype=np.float32)
        pair[0] = self.extrinsics
        pair[1, :3, :3] = self.intrinsics
        return pair


def read_cam_file(
    path: str, interval_scale: float = 1.0, ndepths: int = 192, convention: str = "eval"
) -> CameraInfo:
    """A cam file, intrinsics at stage-1 resolution, read per ``convention``
    ("eval", "dtu_train", "minmax" or "bld")."""
    if convention not in ("eval", "dtu_train", "minmax", "bld"):
        raise ValueError(f"unknown cam convention {convention!r}")
    with open(path) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extr = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intr = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    tokens = lines[11].split()
    depth_min = float(tokens[0])
    depth_interval = float(tokens[1])
    if convention == "dtu_train":
        return CameraInfo(intr, extr, depth_min, depth_interval * interval_scale)
    intr[:2, :] /= 4.0
    if convention in ("minmax", "bld"):
        depth_max = float(tokens[1] if convention == "minmax" else tokens[-1])
        return CameraInfo(intr, extr, depth_min, (depth_max - depth_min) / ndepths, depth_max)
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
    img: torch.Tensor, intrinsics: np.ndarray, max_w: int, max_h: int, base: int = 32
) -> tuple[torch.Tensor, np.ndarray]:
    """Resize img [H, W, 3] to fit (max_h, max_w), snapped down to multiples
    of ``base``, rescaling intrinsics (reference general_eval.py:114-131)."""
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
    return resize_bilinear(img, (int(new_h), int(new_w))), intrinsics
