"""DTU training and DTU-test-style evaluation datasets (reference
datasets/dtu_yao.py, general_eval.py).

Both produce the model's sample contract, channel-last numpy:

  {"imgs": [V, H, W, 3] float32,
   "proj_matrices": {"stage1".."stage3": [V, 2, 4, 4]},
   "depth_values": [Dh],
   train only: "depth"/"mask": {"stageN": [h, w]}, "depth_interval": float,
   eval only:  "filename": "scan/{}/NNNNNNNN{}"}

``cv2`` and ``PIL`` are imported inside the functions that read images;
nearest-neighbour downsampling is numpy (``resize_nearest``).
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
from transmvsnet_tpu_torch.data.pfm import read_pfm


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


def resize_nearest(arr: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(arr, (width, height), interpolation=cv2.INTER_NEAREST)``:
    source index floor(i * src / dst), clamped to the last row/column."""
    h, w = arr.shape[:2]
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))).astype(np.int64), w - 1)
    return arr[ys[:, None], xs[None, :]]


def pyramid(arr: np.ndarray) -> dict[str, np.ndarray]:
    """stage1 = 1/4, stage2 = 1/2, stage3 = full, nearest (dtu_yao.py:96-122)."""
    h, w = arr.shape
    return {
        "stage1": resize_nearest(arr, w // 4, h // 4),
        "stage2": resize_nearest(arr, w // 2, h // 2),
        "stage3": arr,
    }


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


class DTUTrainDataset:
    """Yao Yao's preprocessed DTU: 49 viewpoints x 7 lights per scan.

    Images 1600x1200 -> /2 (nearest) and centre crop to 640x512; the PFM
    depth and the >10-intensity visibility mask go through the same and
    are pyramided per stage (reference datasets/dtu_yao.py). Layout under
    ``datapath``: Cameras/pair.txt, Cameras/train/NNNNNNNN_cam.txt,
    Rectified/<scan>_train/rect_VVV_L_r5000.png,
    Depths_raw/<scan>/depth_map_VVVV.pfm and depth_visual_VVVV.png.
    """

    def __init__(
        self,
        datapath: str,
        listfile: str | list[str],
        mode: str = "train",
        nviews: int = 5,
        ndepths: int = 192,
        interval_scale: float = 1.06,
    ):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode must be train, val or test, got {mode!r}")
        self.datapath = datapath
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        scans = read_scan_list(listfile) if isinstance(listfile, str) else list(listfile)
        pairs = read_pair_file(os.path.join(datapath, "Cameras/pair.txt"))
        self.metas = [
            (scan, light, ref_view, src_views)
            for scan in scans
            for ref_view, src_views in pairs
            for light in range(7)
        ]

    def __len__(self) -> int:
        return len(self.metas)

    @staticmethod
    def prepare_img(hr_img: np.ndarray) -> np.ndarray:
        """1600x1200 -> /2 -> centre crop 640x512 (dtu_yao.py:75-89)."""
        h, w = hr_img.shape[:2]
        ds = resize_nearest(hr_img, w // 2, h // 2)
        h, w = ds.shape[:2]
        sh, sw = (h - 512) // 2, (w - 640) // 2
        return ds[sh : sh + 512, sw : sw + 640]

    def __getitem__(self, idx: int) -> dict[str, Any]:
        from PIL import Image

        scan, light, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]
        imgs, pairs = [], []
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(
                self.datapath, f"Rectified/{scan}_train/rect_{vid + 1:0>3}_{light}_r5000.png"
            )
            cam_path = os.path.join(self.datapath, f"Cameras/train/{vid:0>8}_cam.txt")
            cam = read_cam_file(cam_path, interval_scale=self.interval_scale, convention="dtu_train")
            imgs.append(self.prepare_img(_read_img(img_path)))
            pairs.append(cam.proj_pair())
            if i == 0:
                raw = os.path.join(self.datapath, f"Depths_raw/{scan}")
                mask_hr = np.asarray(Image.open(f"{raw}/depth_visual_{vid:0>4}.png"), dtype=np.float32)
                mask_ms = pyramid(self.prepare_img((mask_hr > 10).astype(np.float32)))
                depth_ms = pyramid(
                    self.prepare_img(read_pfm(f"{raw}/depth_map_{vid:0>4}.pfm")[0].astype(np.float32))
                )
                depth_interval = cam.depth_interval
                depth_values = np.arange(
                    cam.depth_min,
                    cam.depth_interval * self.ndepths + cam.depth_min,
                    cam.depth_interval,
                    dtype=np.float32,
                )
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": stage_proj_matrices(pairs),
            "depth": depth_ms,
            "mask": mask_ms,
            "depth_values": depth_values,
            "depth_interval": np.float32(depth_interval),
        }
