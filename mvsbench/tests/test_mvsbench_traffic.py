"""Scenes and weights repeat from ``--seed``, every seed with the same
sizes."""

import numpy as np
import pytest
import torch

from mvsbench import scene, weights
from mvsbench.tests.tiny import tiny_cell

SEEDS = [0, 7, 2**31 + 11, 2**40 + 3]


def flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in flat(t)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("workload", ["dtu_infer", "dtu_train", "tnt_infer"])
@pytest.mark.parametrize("seed", SEEDS)
def test_pool_repeats(workload, seed):
    cell = tiny_cell(workload)
    part = cell.config["infer" if cell.traffic["kind"] == "infer" else "train"]
    batch = cell.traffic.get("batch", part.get("batch"))
    args = (cell.traffic["pool"], batch, cell.config["scene"], part["views"], part["height"], part["width"],
            cell.traffic["kind"] == "train")
    a, b = scene.pool(seed, *args), scene.pool(seed, *args)
    other = scene.pool(seed + 1, *args)
    for x, y, z in zip(flat(a), flat(b), flat(other)):
        assert x.shape == y.shape == z.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0]["imgs"], other[0]["imgs"])
    for i in range(1, len(a)):
        assert not np.array_equal(a[0]["imgs"], a[i]["imgs"])


def test_cameras_see_the_sweep():
    """Every source projects the reference's central pixel inside its
    image at the middle of the sweep."""
    cell = tiny_cell("dtu_infer")
    s = scene.scene(3, 0, cell.config["scene"], 5, 64, 96)
    p = s["proj_matrices"]["stage3"].astype(np.float64)
    d = s["depth_values"][len(s["depth_values"]) // 2]
    ref_inv = np.linalg.inv(np.concatenate([p[0, 1, :3, :3] @ p[0, 0, :3], p[0, 0, 3:]]))
    for v in range(1, 5):
        fused = np.concatenate([p[v, 1, :3, :3] @ p[v, 0, :3], p[v, 0, 3:]])
        x = fused @ ref_inv @ np.array([48 * d, 32 * d, d, 1.0])
        assert 0 <= x[0] / x[2] <= 95 and 0 <= x[1] / x[2] <= 63


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_weights_repeat(seed):
    cell = tiny_cell("dtu_infer")
    layout = weights.reference_model(cell.config, "cpu")
    a = weights.seeded_state_dict(layout, seed, "cpu", 10.0)
    b = weights.seeded_state_dict(layout, seed, "cpu", 10.0)
    c = weights.seeded_state_dict(layout, seed + 1, "cpu", 10.0)
    assert a.keys() == layout.state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["feature.conv0.0.conv.weight"], c["feature.conv0.0.conv.weight"])
    off = a["feature.out3.1.conv_offset_mask.bias"]
    assert 0.5 < off[:18].abs().mean() < 3.0
