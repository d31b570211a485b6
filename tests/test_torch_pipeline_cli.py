"""The port's evaluation chain through its CLIs on the CPU: infer -> fuse ->
eval_dtu on a 64x64 synthetic scan named "scan1" (DTU naming), held
against the JAX package's ``tools.fuse`` and ``tools.eval_dtu`` run on the
same PFMs (after ``tests/test_cli_pipeline.py::test_dtu_fuse_then_evaluate``),
and infer's ``--batch_size 2`` against batch 1.

The weights are random (seeded, with peaked probability volumes), so the
depth maps agree across views only by chance: the fuser keeps a few dozen
points at a confidence cut of 0.01 over two views, which is what is
compared. A second scan holds the scene's true depth maps (confidence
1, as ``tests/test_fusion_eval.py`` writes them), whose cloud lies on the
plane and scores below 0.5. The DTU-layout ground truth is the plane."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import savemat

from test_torch_fusion import _write_scan
from test_torch_infer_cli import NUM_HYP, _model
from transmvsnet_tpu.fusion.ply import read_ply as jax_read_ply
from transmvsnet_tpu.tools import eval_dtu as jax_eval_dtu
from transmvsnet_tpu.tools import fuse as jax_fuse
from transmvsnet_tpu_torch.data.pfm import read_pfm
from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset, SyntheticScene
from transmvsnet_tpu_torch.fusion.ply import read_ply, write_ply
from transmvsnet_tpu_torch.tools import eval_dtu, fuse, infer

VIEWS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs six workers at once, and torch's intra-op threads
    then wait on one another at every op: the TnT CLI test took 103 s with
    the default threads beside six busy processes, 8 s with one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_dtu_gt(gt_root, scene, scan_id=1):
    """Plane samples as Points/stl, an all-ones observability mask and a
    ground plane below the scene (tests/test_cli_pipeline.py:119-147)."""
    rng = np.random.RandomState(0)
    x, y = rng.uniform(-3, 3, 8000), rng.uniform(-2, 2, 8000)
    z = (scene.c - scene.n[0] * x - scene.n[1] * y) / scene.n[2]
    stl = np.stack([x, y, z], axis=1).astype(np.float32)
    os.makedirs(os.path.join(gt_root, "Points/stl"))
    write_ply(os.path.join(gt_root, f"Points/stl/stl{scan_id:03d}_total.ply"), stl,
              np.full((len(stl), 3), 128, np.uint8))
    os.makedirs(os.path.join(gt_root, "ObsMask"))
    savemat(os.path.join(gt_root, f"ObsMask/ObsMask{scan_id}_10.mat"),
            {"ObsMask": np.ones((40, 40, 40), np.uint8), "BB": np.array([[-5.0, -5.0, 0.0], [15.0, 15.0, 20.0]]),
             "Res": 0.5})
    savemat(os.path.join(gt_root, f"ObsMask/Plane{scan_id}.mat"), {"P": np.array([0.0, 0.0, 1.0, -1.0])})


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    SyntheticDataset(nviews=VIEWS, num_samples=1, height=64, width=64, ndepths=NUM_HYP).materialize(
        str(root / "data"), device="cpu")
    os.rename(root / "data/synth0", root / "data/scan1")
    (root / "list.txt").write_text("scan1\n")
    torch.save({"model": _model().state_dict()}, root / "m.ckpt")
    for batch in (1, 2):
        infer.main(["--datapath", str(root / "data"), "--testlist", str(root / "list.txt"),
                    "--outdir", str(root / f"out{batch}"), "--loadckpt", str(root / "m.ckpt"),
                    "--num_view", "3", "--numdepth", str(NUM_HYP), "--max_h", "64", "--max_w", "64",
                    "--ndepths", "16,8,8", "--batch_size", str(batch), "--device", "cpu"])
    _write_dtu_gt(str(root / "gt"), SyntheticScene(VIEWS, 64, 64, seed=0))
    true_scene = _write_scan(root / "true/scan1", noisy=False)
    _write_dtu_gt(str(root / "gt_true"), true_scene)
    return root


def test_batch_2_writes_what_batch_1_writes(chain):
    """The same samples in batches of two (the last batch of one): depth
    and confidence of every view as batch 1 wrote them, to float32
    summation order (the batch changes the CPU convolutions' blocking)."""
    for v in range(VIEWS):
        for kind in ("depth_est", "confidence"):
            a, _ = read_pfm(str(chain / f"out1/scan1/{kind}/{v:0>8}.pfm"))
            b, _ = read_pfm(str(chain / f"out2/scan1/{kind}/{v:0>8}.pfm"))
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f"{kind} {v}")
        assert (chain / f"out2/scan1/images/{v:0>8}.jpg").read_bytes() == (
            chain / f"out1/scan1/images/{v:0>8}.jpg").read_bytes()


# scan: (outputs, ground truth, fuser flags)
SCANS = {
    "inferred": ("out1", "gt", ["--photo_threshold", "0.01", "--thres_view", "2"]),
    "true_depth": ("true", "gt_true", ["--photo_threshold", "0.5", "--thres_view", "2"]),
}


@pytest.mark.parametrize("scan", sorted(SCANS))
@pytest.mark.parametrize("method", ["dynamic", "normal"])
def test_fuse_and_score_match_jax(chain, tmp_path, capsys, method, scan):
    outputs, gt, flags = SCANS[scan]
    (tmp_path / "list.txt").write_text("scan1\n")
    args = ["--testpath", str(chain / outputs), "--testlist", str(tmp_path / "list.txt"), "--test_dataset", "dtu",
            "--filter_method", method, *flags]
    fuse.main([*args, "--outdir", str(tmp_path / "ours"), "--device", "cpu"])
    jax_fuse.main([*args, "--outdir", str(tmp_path / "theirs"), "--num_workers", "1"])
    ours, ours_rgb = read_ply(str(tmp_path / "ours/mvsnet001_l3.ply"))
    theirs, theirs_rgb = jax_read_ply(str(tmp_path / "theirs/mvsnet001_l3.ply"))
    assert 20 <= len(ours) == len(theirs)
    # Points: float64 geometry on both sides, rounded to float32 in the PLY.
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)
    assert np.abs(ours_rgb.astype(int) - theirs_rgb.astype(int)).max() <= 1

    capsys.readouterr()
    scores = []
    for tool, plydir in ((eval_dtu, "ours"), (jax_eval_dtu, "theirs")):
        tool.main(["--plydir", str(tmp_path / plydir), "--gtpath", str(chain / gt), "--scans", "1"])
        scores.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert np.isfinite(scores[0]["overall"])
    for key in ("acc_mean", "comp_mean", "overall"):
        assert scores[0][key] == pytest.approx(scores[1][key], rel=1e-6), key
    if scan == "true_depth":
        assert len(ours) > 2000 and scores[0]["overall"] < 0.5, scores[0]
