"""DTU-test-style evaluation dataset (reference datasets/general_eval.py).

Produces the model's sample contract, channel-last numpy:

  {"imgs": [V, H, W, 3] float32,
   "proj_matrices": {"stage1".."stage3": [V, 2, 4, 4]},
   "depth_values": [Dh],
   "filename": "scan/{}/NNNNNNNN{}"}

``cv2`` and ``PIL`` are imported inside the functions that read images.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from transmvsnet_tpu_torch.data.cams import (
    CameraInfo,
    read_cam_file,
    read_pair_file,
    scale_mvs_input,
)


def _read_img(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path), dtype=np.float32) / 255.0


def stage_proj_matrices(pairs: list[np.ndarray]) -> dict[str, np.ndarray]:
    """Per-stage [V, 2, 4, 4]: stage1 K as given; stage2/3 scale K's pixel
    rows by 2/4 (reference datasets/dtu_yao.py:174-184)."""
    proj = np.stack(pairs)
    out = {"stage1": proj}
    for name, mult in [("stage2", 2.0), ("stage3", 4.0)]:
        p = proj.copy()
        p[:, 1, :2, :] = proj[:, 1, :2, :] * mult
        out[name] = p
    return out


def read_scan_list(path: str) -> list[str]:
    with open(path) as f:
        return [line.rstrip() for line in f if line.strip()]


class GeneralEvalDataset:
    """Resizes to fit (max_h, max_w) snapped to multiples of 32, rescales
    the intrinsics, pins every sample to the first sample's resolution and
    pads short source-view lists with the best source view."""

    def __init__(
        self,
        datapath: str,
        listfile: str | list[str],
        nviews: int = 5,
        ndepths: int = 192,
        interval_scale: float = 1.0,
        max_h: int = 864,
        max_w: int = 1152,
    ):
        self.datapath = datapath
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.max_h, self.max_w = max_h, max_w
        self._run_hw: tuple[int, int] | None = None
        scans = read_scan_list(listfile) if isinstance(listfile, str) else list(listfile)
        self.metas: list[tuple[str, int, list[int]]] = []
        for scan in scans:
            for ref_view, src_views in read_pair_file(os.path.join(datapath, f"{scan}/pair.txt")):
                if len(src_views) < self.nviews:
                    src_views = src_views + [src_views[0]] * (self.nviews - len(src_views))
                self.metas.append((scan, ref_view, src_views))

    def __len__(self) -> int:
        return len(self.metas)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        import cv2

        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]
        imgs, pairs = [], []
        depth_values = None
        std_hw = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, f"{scan}/images_post/{vid:0>8}.jpg")
            if not os.path.exists(img_path):
                img_path = os.path.join(self.datapath, f"{scan}/images/{vid:0>8}.jpg")
            cam_path = os.path.join(self.datapath, f"{scan}/cams/{vid:0>8}_cam.txt")
            img = _read_img(img_path)
            cam = read_cam_file(cam_path, interval_scale=self.interval_scale, ndepths=self.ndepths)
            img, intr = scale_mvs_input(img, cam.intrinsics, self.max_w, self.max_h)
            if i == 0:
                if self._run_hw is None:
                    self._run_hw = tuple(img.shape[:2])
                std_hw = self._run_hw
            if img.shape[:2] != std_hw:
                sh = std_hw[0] / img.shape[0]
                sw = std_hw[1] / img.shape[1]
                img = cv2.resize(img, (std_hw[1], std_hw[0]))
                intr = intr.copy()
                intr[0, :] *= sw
                intr[1, :] *= sh
            imgs.append(img)
            pairs.append(
                CameraInfo(intr, cam.extrinsics, cam.depth_min, cam.depth_interval).proj_pair()
            )
            if i == 0:
                depth_values = np.arange(
                    cam.depth_min,
                    cam.depth_interval * (self.ndepths - 0.5) + cam.depth_min,
                    cam.depth_interval,
                    dtype=np.float32,
                )
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": stage_proj_matrices(pairs),
            "depth_values": depth_values,
            "filename": scan + "/{}/" + f"{view_ids[0]:0>8}" + "{}",
        }
