"""The benchmark's seeded scenes: images, cameras, hypotheses and, for
training, ground truth. One generator for every configuration and mix:
what a scene looks like is the configuration's ``scene`` block, how many
there are and in what batch the traffic file's.

A scene is a reference camera at the origin looking down +z and source
cameras around it, each at its own baseline and bearing, looking at the
middle of the depth range, with seeded jitter of focal length and
principal point. Images are uniform noise. Hypotheses run from the
scene's near depth in ``num_hyp`` steps of interval times interval_scale.
Training adds a smooth ground-truth surface inside that range and a mask
that leaves a seeded share of pixels invalid. Every seed gives the same
sizes; only values differ.
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, tag: str) -> np.random.Generator:
    """A numpy generator for ``tag`` drawn from ``seed`` (any size)."""
    return np.random.default_rng([abs(seed) % 2**63, abs(seed) // 2**63, int(seed < 0), *tag.encode()])


def _look_at(centre: np.ndarray, target: np.ndarray) -> np.ndarray:
    """4x4 extrinsics (world -> camera, x right, y down, z forward)."""
    z = target - centre
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    rot = np.stack([x, y, z])
    ext = np.eye(4)
    ext[:3, :3] = rot
    ext[:3, 3] = -rot @ centre
    return ext


def cameras(rng: np.random.Generator, sc: dict, views: int, H: int, W: int):
    """({"stage1".."stage3": [V, 2, 4, 4]} float32, depth_min)."""
    d_min = sc["depth_min"] * (1 + rng.uniform(-sc["depth_jitter"], sc["depth_jitter"]))
    d_mid = d_min + 0.5 * sc["depth_interval"] * sc["num_hyp"] * sc["interval_scale"]
    target = np.array([0.0, 0.0, d_mid])
    pairs = np.zeros((views, 2, 4, 4))
    for v in range(views):
        if v == 0:
            ext = np.eye(4)
        else:
            base = rng.uniform(*sc["baseline"])
            bearing = 2 * np.pi * (v - 1) / (views - 1) + rng.uniform(-0.3, 0.3)
            centre = base * np.array([np.cos(bearing), np.sin(bearing), 0.0])
            ext = _look_at(centre, target)
        f = sc["focal"] * W * (1 + rng.uniform(-0.02, 0.02))
        k = np.array([[f, 0, W / 2 + rng.uniform(-0.02, 0.02) * W],
                      [0, f, H / 2 + rng.uniform(-0.02, 0.02) * H], [0, 0, 1]])
        pairs[v, 0] = ext
        pairs[v, 1, :3, :3] = k
        pairs[v, 1, 3, 3] = 1
    projs = {}
    for s, scale in (("stage1", 0.25), ("stage2", 0.5), ("stage3", 1.0)):
        p = pairs.copy()
        p[:, 1, :2, :] *= scale
        projs[s] = p.astype(np.float32)
    return projs, d_min


def scene(seed: int, index: int, sc: dict, views: int, H: int, W: int, with_truth: bool = False,
          tag: str = "scene") -> dict:
    """One sample: imgs [V, H, W, 3], proj_matrices {"stageN": [V, 2, 4, 4]},
    depth_values [num_hyp]; with truth also depth and mask {"stageN":
    [h, w]} and depth_interval []."""
    rng = rng_for(seed, f"{tag}{index}")
    projs, d_min = cameras(rng, sc, views, H, W)
    interval = sc["depth_interval"] * sc["interval_scale"]
    out = {
        "imgs": rng.random((views, H, W, 3), dtype=np.float32),
        "proj_matrices": projs,
        "depth_values": (d_min + interval * np.arange(sc["num_hyp"])).astype(np.float32),
    }
    if with_truth:
        span = interval * sc["num_hyp"]
        yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
        a = rng.uniform(-1, 1, 6)
        frac = 0.5 + 0.15 * a[0] * (xx - 0.5) + 0.15 * a[1] * (yy - 0.5) \
            + 0.1 * np.sin(2 * np.pi * (1.5 + a[2]) * xx + 3 * a[3]) * np.cos(2 * np.pi * (1 + a[4]) * yy)
        depth = (d_min + span * np.clip(frac, 0.1, 0.9)).astype(np.float32)
        field = np.sin(2 * np.pi * (2 + a[5]) * xx + 5 * a[3]) + np.cos(2 * np.pi * 1.7 * yy + 5 * a[2])
        mask = (field > np.quantile(field, sc["invalid_share"])).astype(np.float32)
        out["depth"] = {"stage1": depth[::4, ::4], "stage2": depth[::2, ::2], "stage3": depth}
        out["mask"] = {"stage1": mask[::4, ::4], "stage2": mask[::2, ::2], "stage3": mask}
        out["depth_interval"] = np.float32(interval)
    return out


def batch_of(samples: list[dict]) -> dict:
    """Samples stacked into one batch, leading dim B."""
    def stack(vals):
        if isinstance(vals[0], dict):
            return {k: stack([v[k] for v in vals]) for k in vals[0]}
        return np.stack(vals)

    return {k: stack([s[k] for s in samples]) for k in samples[0]}


def pool(seed: int, count: int, batch: int, sc: dict, views: int, H: int, W: int,
         with_truth: bool = False, tag: str = "scene") -> list[dict]:
    """``count`` batches of ``batch`` distinct samples each."""
    return [batch_of([scene(seed, i * batch + b, sc, views, H, W, with_truth, tag) for b in range(batch)])
            for i in range(count)]
