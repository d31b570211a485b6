"""Example model inputs for smoke runs and profiling (numpy, channel-last).

Random images, cameras with a slight yaw per view and a DTU-like narrow
field of view (stage-1 intrinsics, scaled x2 and x4 for stages 2 and 3),
and the DTU hypothesis sweep over [425, 931.45].
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
