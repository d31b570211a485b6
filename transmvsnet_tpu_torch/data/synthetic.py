"""Procedural multi-view scene with analytic ground-truth depth (numpy only).

A textured slanted plane observed by a ring of pinhole cameras: a training
and inference fixture that needs no data on disk. ``materialize`` writes it
in the DTU evaluation layout (images/, cams/, pair.txt) for the CLI,
its JPEGs through ``data/image_io.write_jpeg`` on the device it is given.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from transmvsnet_tpu_torch.data.datasets import pyramid
from transmvsnet_tpu_torch.data.image_io import write_jpeg
from transmvsnet_tpu_torch.models.blocks import resolve_device

FOCAL = 120.0
PLANE_NORMAL = (0.15, -0.1, 1.0)
PLANE_OFFSET = 6.0
BASELINE = 0.4  # camera-centre spacing: ~1.3 px of disparity per unit depth at z ~ 6


def _texture(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Smooth RGB texture over world coordinates."""
    r = 0.5 + 0.5 * np.sin(3.1 * x) * np.cos(2.7 * y)
    g = 0.5 + 0.5 * np.sin(1.7 * x + 2.3 * y)
    b = 0.5 + 0.25 * np.sin(5.3 * x) + 0.25 * np.cos(4.1 * y)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


class SyntheticScene:
    """V cameras looking at the plane n·p = c from ~(0, 0, 0) along +z.
    ``focal`` in pixels; the default (the JAX package's) suits ~96x64
    images: larger images keep that field of view with a focal scaled by
    their width over 96."""

    def __init__(self, num_views: int = 5, height: int = 64, width: int = 96, seed: int = 0,
                 focal: float = FOCAL):
        self.V, self.H, self.W = num_views, height, width
        n = np.asarray(PLANE_NORMAL, dtype=np.float64)
        self.n = n / np.linalg.norm(n)
        self.c = PLANE_OFFSET
        self.K = np.array(
            [[focal, 0, width / 2.0], [0, focal, height / 2.0], [0, 0, 1]], dtype=np.float64
        )
        rng = np.random.RandomState(seed)
        self.extrinsics = []
        for v in range(num_views):
            # A convergent ring: the camera centre is -R^T t, so a camera
            # with translation +t sits at -t and yaws by -t/plane_offset to
            # keep the plane centred.
            ang = -BASELINE * (v - (num_views - 1) / 2) / PLANE_OFFSET
            tilt = 0.03 * rng.randn()
            Ry = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
            Rx = np.array([[1, 0, 0], [0, np.cos(tilt), -np.sin(tilt)], [0, np.sin(tilt), np.cos(tilt)]])
            E = np.eye(4)
            E[:3, :3] = Ry @ Rx
            E[:3, 3] = [BASELINE * (v - (num_views - 1) / 2), 0.05 * rng.randn(), 0.0]
            self.extrinsics.append(E)

    def render(self, view: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (image [H, W, 3], depth [H, W]) for one camera."""
        E = self.extrinsics[view]
        R, t = E[:3, :3], E[:3, 3]
        u, v = np.meshgrid(np.arange(self.W), np.arange(self.H))
        pix = np.stack([u, v, np.ones_like(u)], axis=-1).astype(np.float64)
        d_cam = pix @ np.linalg.inv(self.K).T  # [H, W, 3], z component 1
        # World ray p_w = R^-1 (depth * d - t) meets the plane n·p_w = c.
        d_w = d_cam @ R
        o_w = -R.T @ t
        depth = (self.c - o_w @ self.n) / np.maximum(d_w @ self.n, 1e-9)
        p_w = o_w[None, None] + depth[..., None] * d_w
        return _texture(p_w[..., 0], p_w[..., 1]), depth.astype(np.float32)

    def surface_points(self, stride: int = 1) -> np.ndarray:
        """Exact surface samples: every view's true depths unprojected to the
        world, every ``stride``-th row and column; float32 [N, 3] (the
        analytic counterpart of DTU's STL ground-truth cloud)."""
        pts = []
        for v in range(self.V):
            E = self.extrinsics[v]
            R, t = E[:3, :3], E[:3, 3]
            _, depth = self.render(v)
            u, vv = np.meshgrid(np.arange(self.W), np.arange(self.H))
            pix = np.stack([u, vv, np.ones_like(u)], axis=-1).astype(np.float64)
            d_w = (pix @ np.linalg.inv(self.K).T) @ R  # R^T per row
            p = (-R.T @ t)[None, None] + depth[..., None] * d_w
            pts.append(p[::stride, ::stride].reshape(-1, 3))
        return np.concatenate(pts, axis=0).astype(np.float32)

    def depth_range(self) -> tuple[float, float]:
        depths = [self.render(v)[1] for v in range(self.V)]
        lo = min(float(d.min()) for d in depths)
        hi = max(float(d.max()) for d in depths)
        margin = 0.25 * (hi - lo) + 1e-3
        return lo - margin, hi + margin


class SyntheticDataset:
    """The sample contract over SyntheticScene, as the JAX package's
    ``SyntheticDataset`` gives it: {"imgs" [V, H, W, 3], "proj_matrices"
    {"stageN": [V, 2, 4, 4]}, "depth_values" [ndepths], the training
    targets "depth" and "mask" {"stageN": [h, w]} (the reference view's
    depth, nearest-downsampled to 1/4 and 1/2; all valid) and
    "depth_interval", and "filename"}. ``datapath``, ``listfile`` and
    ``mode`` are accepted for the CLIs' sake and unused."""

    def __init__(
        self,
        datapath: str = "",
        listfile: str | list[str] = "",
        nviews: int = 5,
        ndepths: int = 48,
        num_samples: int = 4,
        height: int = 64,
        width: int = 96,
        focal: float = FOCAL,
        **kwargs,
    ):
        self.ndepths = ndepths
        self.num_samples = num_samples
        self.scenes = [SyntheticScene(nviews, height, width, seed=i, focal=focal) for i in range(num_samples)]

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> dict[str, Any]:
        scene = self.scenes[idx]
        imgs, depths = zip(*(scene.render(v) for v in range(scene.V)))
        lo, hi = scene.depth_range()
        interval = (hi - lo) / self.ndepths
        pairs = np.zeros((scene.V, 2, 4, 4), dtype=np.float32)
        for v in range(scene.V):
            pairs[v, 0] = scene.extrinsics[v]
            # Stage-1 intrinsics: pixel rows at 1/4 resolution, K[2, 2] = 1.
            pairs[v, 1, :3, :3] = scene.K
            pairs[v, 1, :2, :] /= 4.0
        stages = {"stage1": pairs}
        for name, mult in [("stage2", 2.0), ("stage3", 4.0)]:
            p = pairs.copy()
            p[:, 1, :2, :] *= mult
            stages[name] = p
        depth_ms = pyramid(depths[0])
        return {
            "imgs": np.stack(imgs),
            "proj_matrices": stages,
            "depth": depth_ms,
            "mask": {k: np.ones_like(v) for k, v in depth_ms.items()},
            "depth_values": (lo + np.arange(self.ndepths) * interval).astype(np.float32),
            "depth_interval": np.float32(interval),
            "filename": f"synth{idx}" + "/{}/" + "00000000{}",
        }

    def materialize(self, outdir: str, device: str | torch.device = "cuda") -> None:
        """Write DTU-eval-layout files (images/, cams/, pair.txt), encoding
        the JPEGs on ``device`` (nvJPEG on CUDA, cv2 on the CPU)."""
        from transmvsnet_tpu_torch.data.cams import write_cam_file

        device = resolve_device(device)
        for idx, scene in enumerate(self.scenes):
            scan_dir = os.path.join(outdir, f"synth{idx}")
            os.makedirs(os.path.join(scan_dir, "images"), exist_ok=True)
            os.makedirs(os.path.join(scan_dir, "cams"), exist_ok=True)
            lo, hi = scene.depth_range()
            interval = (hi - lo) / self.ndepths
            for v in range(scene.V):
                img, _ = scene.render(v)
                write_jpeg(
                    os.path.join(scan_dir, f"images/{v:0>8}.jpg"),
                    torch.from_numpy((img * 255).astype(np.uint8)).to(device),
                )
                pair = np.zeros((2, 4, 4), dtype=np.float32)
                pair[0] = scene.extrinsics[v]
                pair[1, :3, :3] = scene.K  # full-resolution intrinsics on disk
                write_cam_file(
                    os.path.join(scan_dir, f"cams/{v:0>8}_cam.txt"),
                    pair,
                    depth_line=f"{lo:.6f} {interval:.6f}",
                )
            with open(os.path.join(scan_dir, "pair.txt"), "w") as f:
                f.write(f"{scene.V}\n")
                for v in range(scene.V):
                    others = [o for o in range(scene.V) if o != v]
                    f.write(f"{v}\n")
                    f.write(
                        f"{len(others)} "
                        + " ".join(f"{o} {100.0 - i}" for i, o in enumerate(others))
                        + "\n"
                    )
