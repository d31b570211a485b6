"""DTU and BlendedMVS training, DTU-test-style and Tanks-and-Temples
evaluation datasets (reference datasets/dtu_yao.py, bld_train.py,
general_eval.py, tnt_eval.py).

All produce the model's sample contract, channel-last numpy:

  {"imgs": [V, H, W, 3] float32,
   "proj_matrices": {"stage1".."stage3": [V, 2, 4, 4]},
   "depth_values": [Dh],
   train only: "depth"/"mask": {"stageN": [h, w]}, "depth_interval": float,
   eval only:  "filename": "scan/{}/NNNNNNNN{}"}

Images go through ``data/image_io.py``. Every dataset that reads images
takes a ``device`` (CUDA unless the caller says CPU). The evaluation
datasets and BlendedMVS decode each JPEG there (nvJPEG on the card, PIL on
the CPU), resize it there, and hand back numpy. DTU's training images are
PNGs, decoded on the host: by the compiled unfilter for a CUDA device, by
numpy on the CPU. Nearest-neighbour downsampling is numpy
(``resize_nearest``).
"""

from __future__ import annotations

import os
import threading
from typing import Any

import numpy as np
import torch

from transmvsnet_tpu_torch.data.cams import (
    CameraInfo,
    read_cam_file,
    read_pair_file,
    scale_mvs_input,
)
from transmvsnet_tpu_torch.data import image_io
from transmvsnet_tpu_torch.data.image_io import png_rgb, read_image, read_png, resize_bilinear
from transmvsnet_tpu_torch.data.pfm import read_pfm
from transmvsnet_tpu_torch.models.blocks import resolve_device


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


def _fit_view(img: torch.Tensor, intr: np.ndarray, std_hw: tuple[int, int]):
    """A view resized to the sample's (H, W) where it differs, with its
    intrinsics rescaled to match."""
    if tuple(img.shape[:2]) == tuple(std_hw):
        return img, intr
    intr = intr.copy()
    intr[0, :] *= std_hw[1] / img.shape[1]
    intr[1, :] *= std_hw[0] / img.shape[0]
    return resize_bilinear(img, std_hw), intr


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
        device: str | torch.device = "cuda",
    ):
        self.datapath = datapath
        self.device = resolve_device(device)
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.max_h, self.max_w = max_h, max_w
        self._run_hw: tuple[int, int] | None = None
        self._run_hw_lock = threading.Lock()  # the loader builds samples on threads
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
            img = read_image(img_path, self.device)
            cam = read_cam_file(cam_path, interval_scale=self.interval_scale, ndepths=self.ndepths)
            img, intr = scale_mvs_input(img, cam.intrinsics, self.max_w, self.max_h)
            if i == 0:
                with self._run_hw_lock:
                    if self._run_hw is None:
                        self._run_hw = tuple(img.shape[:2])
                std_hw = self._run_hw
            img, intr = _fit_view(img, intr, std_hw)
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
            "imgs": torch.stack(imgs).cpu().numpy(),
            "proj_matrices": stage_proj_matrices(pairs),
            "depth_values": depth_values,
            "filename": scan + "/{}/" + f"{view_ids[0]:0>8}" + "{}",
        }


class TnTEvalDataset:
    """Tanks and Temples evaluation (reference datasets/tnt_eval.py): per-scene
    native sizes, cams from cams_1/ in the "minmax" convention, optional
    inverse-depth hypotheses.

    With ``pad_views`` every sample has exactly ``nviews`` views (a short
    source list padded with its best view, general_eval.py:53-57), else
    the reference's per-sample clipping to the views available.
    ``bucket_hw`` (H, W) resizes every scene to one size, snapped down to
    multiples of 32, rescaling the intrinsics with it.
    """

    IMAGE_SIZES = {
        "Family": (1920, 1080),
        "Francis": (1920, 1080),
        "Horse": (1920, 1080),
        "Lighthouse": (2048, 1080),
        "M60": (2048, 1080),
        "Panther": (2048, 1080),
        "Playground": (1920, 1080),
        "Train": (1920, 1080),
        "Auditorium": (1920, 1080),
        "Ballroom": (1920, 1080),
        "Courtroom": (1920, 1080),
        "Museum": (1920, 1080),
        "Palace": (1920, 1080),
        "Temple": (1920, 1080),
    }

    def __init__(
        self,
        datapath: str,
        listfile: str | list[str],
        nviews: int = 11,
        ndepths: int = 192,
        interval_scale: float = 1.0,
        inverse_depth: bool = False,
        pad_views: bool = True,
        bucket_hw: tuple[int, int] | None = None,
        device: str | torch.device = "cuda",
    ):
        self.datapath = datapath
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.inverse_depth = inverse_depth
        self.pad_views = pad_views
        self.bucket_hw = bucket_hw
        self.device = resolve_device(device)
        scans = read_scan_list(listfile) if isinstance(listfile, str) else list(listfile)
        self.metas: list[tuple[str, int, list[int]]] = []
        for scan in scans:
            for ref_view, src_views in read_pair_file(os.path.join(datapath, f"{scan}/pair.txt")):
                self.metas.append((scan, ref_view, src_views))

    def __len__(self) -> int:
        return len(self.metas)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        scan, ref_view, src_views = self.metas[idx]
        if self.pad_views:
            if len(src_views) < self.nviews - 1 and src_views:
                src_views = src_views + [src_views[0]] * (self.nviews - 1 - len(src_views))
            nviews = self.nviews
        else:
            nviews = min(self.nviews, len(src_views) + 1)
        view_ids = [ref_view] + src_views[: nviews - 1]
        if self.bucket_hw is not None:
            max_h, max_w = self.bucket_hw
            std_hw = (max_h // 32 * 32, max_w // 32 * 32)
        else:
            max_w, max_h = self.IMAGE_SIZES[scan]
            std_hw = None

        imgs, pairs = [], []
        depth_values = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, f"{scan}/images/{vid:0>8}.jpg")
            cam_path = os.path.join(self.datapath, f"{scan}/cams_1/{vid:0>8}_cam.txt")
            img = read_image(img_path, self.device)
            cam = read_cam_file(cam_path, ndepths=self.ndepths, convention="minmax")
            img, intr = scale_mvs_input(img, cam.intrinsics, max_w, max_h)
            if std_hw is None:
                std_hw = tuple(img.shape[:2])
            img, intr = _fit_view(img, intr, std_hw)
            imgs.append(img)
            pairs.append(
                CameraInfo(intr, cam.extrinsics, cam.depth_min, cam.depth_interval).proj_pair()
            )
            if i == 0:
                if not self.inverse_depth:
                    depth_values = np.arange(
                        cam.depth_min,
                        cam.depth_interval * self.ndepths + cam.depth_min,
                        cam.depth_interval,
                        dtype=np.float32,
                    )[: self.ndepths]
                else:
                    depth_end = cam.depth_max - cam.depth_interval / self.interval_scale
                    inv = np.linspace(1.0 / depth_end, 1.0 / cam.depth_min, self.ndepths, endpoint=False)
                    depth_values = (1.0 / inv).astype(np.float32)
        return {
            "imgs": torch.stack(imgs).cpu().numpy(),
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
    For a CUDA ``device`` the PNGs are unfiltered by the compiled routine
    (built here, so that a failed build raises before training starts).
    """

    def __init__(
        self,
        datapath: str,
        listfile: str | list[str],
        mode: str = "train",
        nviews: int = 5,
        ndepths: int = 192,
        interval_scale: float = 1.06,
        device: str | torch.device = "cuda",
    ):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode must be train, val or test, got {mode!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            image_io.png_unfilter_library()
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
        scan, light, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]
        imgs, pairs = [], []
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(
                self.datapath, f"Rectified/{scan}_train/rect_{vid + 1:0>3}_{light}_r5000.png"
            )
            cam_path = os.path.join(self.datapath, f"Cameras/train/{vid:0>8}_cam.txt")
            cam = read_cam_file(cam_path, interval_scale=self.interval_scale, convention="dtu_train")
            # Crop first, then scale to [0, 1] as read_image does: the same
            # float32 values on a quarter of the pixels.
            img = self.prepare_img(png_rgb(read_png(img_path, self.device)))
            imgs.append(img.astype(np.float32) / np.float32(255.0))
            pairs.append(cam.proj_pair())
            if i == 0:
                raw = os.path.join(self.datapath, f"Depths_raw/{scan}")
                mask_hr = read_png(f"{raw}/depth_visual_{vid:0>4}.png", self.device).astype(np.float32)
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


class BlendedTrainDataset:
    """BlendedMVS finetuning (reference datasets/bld_train.py), 768x576
    images. Layout under ``datapath``: <scan>/blended_images/NNNNNNNN.jpg,
    <scan>/cams/NNNNNNNN_cam.txt (the "bld" convention), <scan>/cams/pair.txt
    and <scan>/rendered_depth_maps/NNNNNNNN.pfm. The depth range is the
    cam's line 11 (first and last tokens); the mask keeps depths within
    [min, min + interval * (ndepths - 1)]. References with fewer than
    ``nviews - 1`` source views are skipped. JPEGs are decoded on
    ``device`` (nvJPEG on the card, PIL on the CPU). ``interval_scale`` is
    taken, as the CLI passes it, and unused, as in the reference."""

    def __init__(
        self,
        datapath: str,
        listfile: str | list[str],
        mode: str = "train",
        nviews: int = 4,
        ndepths: int = 192,
        interval_scale: float = 1.0,
        device: str | torch.device = "cuda",
    ):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode must be train, val or test, got {mode!r}")
        self.datapath = datapath
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.device = resolve_device(device)
        scans = read_scan_list(listfile) if isinstance(listfile, str) else list(listfile)
        self.metas = [
            (scan, ref_view, src_views)
            for scan in scans
            for ref_view, src_views in read_pair_file(os.path.join(datapath, f"{scan}/cams/pair.txt"))
            if len(src_views) >= self.nviews - 1
        ]

    def __len__(self) -> int:
        return len(self.metas)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]
        imgs, pairs = [], []
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, f"{scan}/blended_images/{vid:0>8}.jpg")
            cam_path = os.path.join(self.datapath, f"{scan}/cams/{vid:0>8}_cam.txt")
            cam = read_cam_file(cam_path, ndepths=self.ndepths, convention="bld")
            imgs.append(read_image(img_path, self.device))
            pairs.append(cam.proj_pair())
            if i == 0:
                depth = read_pfm(os.path.join(self.datapath, f"{scan}/rendered_depth_maps/{vid:0>8}.pfm"))[0]
                depth = depth.astype(np.float32)
                depth_end = cam.depth_interval * (self.ndepths - 1) + cam.depth_min
                mask = ((depth >= cam.depth_min) & (depth <= depth_end)).astype(np.float32)
                depth_interval = cam.depth_interval
                depth_values = np.arange(
                    cam.depth_min,
                    cam.depth_interval * self.ndepths + cam.depth_min,
                    cam.depth_interval,
                    dtype=np.float32,
                )
        return {
            "imgs": torch.stack(imgs).cpu().numpy(),
            "proj_matrices": stage_proj_matrices(pairs),
            "depth": pyramid(depth),
            "mask": pyramid(mask),
            "depth_values": depth_values,
            "depth_interval": np.float32(depth_interval),
        }
