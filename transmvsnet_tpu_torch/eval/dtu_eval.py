"""DTU accuracy/completeness benchmark evaluation in Python, the port's own
copy of the JAX package's ``eval/dtu_eval.py`` (numpy and scipy on the
host).

Re-implements the reference's MATLAB evaluation pipeline so no MATLAB is
required (algorithmic spec: reference DTU-MATLAB/PointCompareMain.m,
BaseEvalMain_web.m, MaxDistCP.m, reducePts_haa.m, ComputeStat_web.m):

- stochastic 0.2 mm min-spacing downsample of the data cloud,
- accuracy  = 1-NN distance data→GT(stl), filtered by the observability
  mask and a 20 mm outlier cap,
- completeness = 1-NN distance GT→data, filtered by the above-ground-plane
  test and the same cap,
- overall = (mean accuracy + mean completeness) / 2, averaged over the 22
  DTU evaluation scans.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
from scipy.spatial import cKDTree

# The 22 DTU evaluation scans (reference DTU-MATLAB/BaseEvalMain_web.m:25).
DTU_EVAL_SETS = [
    1, 4, 9, 10, 11, 12, 13, 15, 23, 24, 29,
    32, 33, 34, 48, 49, 62, 75, 77, 110, 114, 118,
]


def dtu_ply_name(scan_id: int) -> str:
    """Canonical fused-cloud filename for a DTU scan.

    Single source of truth shared by the fuser (which writes it) and the
    evaluator (which reads it); spec: reference DTU-MATLAB/
    BaseEvalMain_web.m:34 ``mvsnet%03d_l3.ply``.
    """
    return f"mvsnet{scan_id:03d}_l3.ply"


def reduce_points(
    pts: np.ndarray, min_dist: float = 0.2, seed: int = 0
) -> np.ndarray:
    """Greedy stochastic min-spacing downsample (reducePts_haa.m).

    Visits points in random order; a point is kept if no already-kept point
    lies within ``min_dist``.
    """
    n = len(pts)
    if n == 0:
        return pts
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    tree = cKDTree(pts)
    removed = np.zeros(n, dtype=bool)
    # Chunked neighbor queries in visit order.
    chunk = 200_000
    for start in range(0, n, chunk):
        idxs = order[start : start + chunk]
        active = idxs[~removed[idxs]]
        if len(active) == 0:
            continue
        neighbor_lists = tree.query_ball_point(
            pts[active], min_dist, workers=-1
        )
        for i, neigh in zip(active, neighbor_lists):
            if removed[i]:
                continue
            removed[neigh] = True
            removed[i] = False
    return pts[~removed]


def nn_distances(
    query: np.ndarray, ref: np.ndarray, max_dist: float = 60.0
) -> np.ndarray:
    """1-NN distance from each query point into ref, capped at max_dist
    (MaxDistCP.m semantics)."""
    if len(query) == 0:
        return np.zeros((0,), np.float64)
    tree = cKDTree(ref)
    d, _ = tree.query(query, k=1, distance_upper_bound=max_dist, workers=-1)
    return np.minimum(d, max_dist)


def evaluate_point_cloud(
    data_pts: np.ndarray,
    stl_pts: np.ndarray,
    min_dist: float = 0.2,
    max_dist: float = 60.0,
    outlier_thresh: float = 20.0,
    data_mask_fn: Callable[[np.ndarray], np.ndarray] | None = None,
    stl_above_plane_fn: Callable[[np.ndarray], np.ndarray] | None = None,
    reduce_data: bool = True,
) -> dict[str, float]:
    """Accuracy/completeness between a reconstructed and a GT cloud."""
    if reduce_data:
        data_pts = reduce_points(data_pts, min_dist)

    d_data = nn_distances(data_pts, stl_pts, max_dist)  # accuracy distances
    d_stl = nn_distances(stl_pts, data_pts, max_dist)  # completeness distances

    if data_mask_fn is not None:
        d_data = d_data[data_mask_fn(data_pts)]
    if stl_above_plane_fn is not None:
        d_stl = d_stl[stl_above_plane_fn(stl_pts)]

    d_data = d_data[d_data < outlier_thresh]
    d_stl = d_stl[d_stl < outlier_thresh]

    acc_mean = float(np.mean(d_data)) if len(d_data) else float("nan")
    comp_mean = float(np.mean(d_stl)) if len(d_stl) else float("nan")
    return {
        "acc_mean": acc_mean,
        "acc_median": float(np.median(d_data)) if len(d_data) else float("nan"),
        "comp_mean": comp_mean,
        "comp_median": float(np.median(d_stl)) if len(d_stl) else float("nan"),
        "overall": (acc_mean + comp_mean) / 2.0,
    }


def _load_obs_mask(path: str):
    """ObsMaskN_10.mat → (ObsMask bool array, BB [2, 3], Res scalar)."""
    from scipy.io import loadmat

    m = loadmat(path)
    return np.asarray(m["ObsMask"]), np.asarray(m["BB"]), float(np.ravel(m["Res"])[0])


def make_dtu_mask_fn(obs_mask: np.ndarray, bb: np.ndarray, res: float):
    """Observability-mask membership test (PointCompareMain.m:30-41)."""

    def mask_fn(pts: np.ndarray) -> np.ndarray:
        qv = np.round((pts - bb[0][None]) / res + 1).astype(np.int64)
        ok = (
            (qv[:, 0] > 0)
            & (qv[:, 0] <= obs_mask.shape[0])
            & (qv[:, 1] > 0)
            & (qv[:, 1] <= obs_mask.shape[1])
            & (qv[:, 2] > 0)
            & (qv[:, 2] <= obs_mask.shape[2])
        )
        inside = np.zeros(len(pts), dtype=bool)
        qi = qv[ok] - 1  # MATLAB 1-based
        inside[ok] = obs_mask[qi[:, 0], qi[:, 1], qi[:, 2]] != 0
        return inside

    return mask_fn


def make_plane_fn(plane: np.ndarray):
    """Above-ground-plane test P'·[x;1] > 0 (PointCompareMain.m:51-53)."""
    plane = np.ravel(plane)

    def plane_fn(pts: np.ndarray) -> np.ndarray:
        return pts @ plane[:3] + plane[3] > 0

    return plane_fn


def evaluate_dtu_scan(
    ply_path: str, data_path: str, scan_id: int, min_dist: float = 0.2
) -> dict[str, float]:
    """Evaluate one scan against DTU ground truth on disk.

    Expects the official layout: Points/stl/stlNNN_total.ply,
    ObsMask/ObsMaskN_10.mat, ObsMask/PlaneN.mat.
    """
    from scipy.io import loadmat

    from transmvsnet_tpu_torch.fusion.ply import read_ply

    data_pts, _ = read_ply(ply_path)
    stl_pts, _ = read_ply(
        os.path.join(data_path, f"Points/stl/stl{scan_id:03d}_total.ply")
    )
    obs_mask, bb, res = _load_obs_mask(
        os.path.join(data_path, f"ObsMask/ObsMask{scan_id}_10.mat")
    )
    plane = loadmat(os.path.join(data_path, f"ObsMask/Plane{scan_id}.mat"))["P"]
    return evaluate_point_cloud(
        data_pts.astype(np.float64),
        stl_pts.astype(np.float64),
        min_dist=min_dist,
        data_mask_fn=make_dtu_mask_fn(obs_mask, bb, res),
        stl_above_plane_fn=make_plane_fn(plane),
    )


def evaluate_dtu(
    ply_dir: str,
    data_path: str,
    scan_ids: list[int] = DTU_EVAL_SETS,
) -> dict[str, float]:
    """Mean acc/comp/overall over the evaluation scans (ComputeStat_web.m)."""
    accs, comps = [], []
    per_scan = {}
    for sid in scan_ids:
        ply = os.path.join(ply_dir, dtu_ply_name(sid))
        r = evaluate_dtu_scan(ply, data_path, sid)
        per_scan[sid] = r
        accs.append(r["acc_mean"])
        comps.append(r["comp_mean"])
    acc = float(np.mean(accs))
    comp = float(np.mean(comps))
    return {
        "acc_mean": acc,
        "comp_mean": comp,
        "overall": (acc + comp) / 2.0,
        "per_scan": per_scan,
    }
