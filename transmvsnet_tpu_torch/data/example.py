"""Example model inputs for smoke runs and profiling (numpy, channel-last).

Random images, cameras with a slight yaw per view and a DTU-like narrow
field of view (stage-1 intrinsics, scaled x2 and x4 for stages 2 and 3),
and the DTU hypothesis sweep over [425, 931.45]; for training, a smooth
depth target inside that range with all-valid masks.
"""

from __future__ import annotations

import numpy as np

DEPTH_MIN, DEPTH_MAX = 425.0, 931.45


def example_inputs(B=1, V=5, H=256, W=320, num_hyp=192, seed=0):
    """(imgs [B, V, H, W, 3], {"stageN": [B, V, 2, 4, 4]}, depth_values [B, num_hyp])."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(B, V, H, W, 3).astype(np.float32)
    pairs = np.zeros((B, V, 2, 4, 4), dtype=np.float32)
    for v in range(V):
        ang = 0.02 * (v - (V - 1) / 2)
        R = np.array(
            [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]],
            dtype=np.float32,
        )
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = R
        E[:3, 3] = [30.0 * v, 2.0 * v, 0.0]
        K = np.array(
            [[0.75 * W, 0, W / 8.0], [0, 0.75 * W, H / 8.0], [0, 0, 1]], dtype=np.float32
        )
        pairs[:, v, 0] = E
        pairs[:, v, 1, :3, :3] = K
    projs = {}
    for s, mult in [("stage1", 1.0), ("stage2", 2.0), ("stage3", 4.0)]:
        p = pairs.copy()
        p[:, :, 1, :2, :] *= mult
        projs[s] = p
    dv = np.broadcast_to(
        np.linspace(DEPTH_MIN, DEPTH_MAX, num_hyp, dtype=np.float32)[None], (B, num_hyp)
    ).copy()
    return imgs, projs, dv


def example_train_batch(B=2, V=5, H=512, W=640, num_hyp=192, seed=0):
    """``example_inputs`` plus the training targets, as a loader batch:
    "depth" and "mask" {"stageN": [B, h, w]} (a smooth slanted depth map
    inside the hypothesis range, nearest-downsampled to 1/4 and 1/2;
    all valid) and "depth_interval" [B]."""
    imgs, projs, dv = example_inputs(B=B, V=V, H=H, W=W, num_hyp=num_hyp, seed=seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    frac = 0.35 + 0.3 * yy / H + 0.05 * np.sin(xx / 40.0)
    depth = np.broadcast_to(DEPTH_MIN + (DEPTH_MAX - DEPTH_MIN) * frac, (B, H, W)).astype(np.float32)
    pyr = {"stage1": depth[:, ::4, ::4], "stage2": depth[:, ::2, ::2], "stage3": depth}
    return {
        "imgs": imgs,
        "proj_matrices": projs,
        "depth_values": dv,
        "depth": pyr,
        "mask": {k: np.ones_like(v) for k, v in pyr.items()},
        "depth_interval": np.full(B, (DEPTH_MAX - DEPTH_MIN) / num_hyp, np.float32),
    }
