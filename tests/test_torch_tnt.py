"""The port's Tanks-and-Temples loader against the JAX package's, on the
tree of ``tests/test_tnt_bucketing.py`` (two scenes of native sizes 96x64
and 128x64, ragged source lists, "minmax" cameras with depth line "2.0
10.0"): per-view padding or clipping, ``bucket_hw``, inverse-depth
hypotheses, and the inference CLI's ``--dataset tnt`` on the same tree."""

import numpy as np
import pytest
import torch

from test_tnt_bucketing import _materialize_tnt_scene
from transmvsnet_tpu.data.datasets import TnTEvalDataset as JaxTnTEvalDataset
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.data.datasets import TnTEvalDataset
from transmvsnet_tpu_torch.data.pfm import read_pfm
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
from transmvsnet_tpu_torch.tools import infer

SIZES = {"MiniA": (96, 64), "MiniB": (128, 64)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs six workers at once, and torch's intra-op threads
    then wait on one another at every op: the TnT CLI test took 103 s with
    the default threads beside six busy processes, 8 s with one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tnt_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tnt"))
    _materialize_tnt_scene(root, "MiniA", SIZES["MiniA"], 4, [3, 1, 2, 3])
    _materialize_tnt_scene(root, "MiniB", SIZES["MiniB"], 3, [2, 2, 1])
    return root


@pytest.fixture
def sizes(monkeypatch):
    for cls in (TnTEvalDataset, JaxTnTEvalDataset):
        monkeypatch.setattr(cls, "IMAGE_SIZES", {**cls.IMAGE_SIZES, **SIZES})


CASES = {
    "padded": dict(),
    "clipped": dict(pad_views=False),
    "bucketed": dict(bucket_hw=(64, 96)),
    "inverse_depth": dict(inverse_depth=True, interval_scale=1.06),
    "inverse_bucketed_clipped": dict(inverse_depth=True, bucket_hw=(70, 100), pad_views=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_samples_match_jax(tnt_root, sizes, case):
    kw = dict(nviews=4, ndepths=16, **CASES[case])
    ours = TnTEvalDataset(tnt_root, ["MiniA", "MiniB"], device="cpu", **kw)
    theirs = JaxTnTEvalDataset(tnt_root, ["MiniA", "MiniB"], **kw)
    assert ours.metas == theirs.metas and len(ours) == 7
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a["filename"] == b["filename"]
        assert a["imgs"].shape == b["imgs"].shape and a["imgs"].dtype == np.float32
        np.testing.assert_allclose(a["imgs"], b["imgs"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(a["depth_values"], b["depth_values"], rtol=1e-6, atol=0)
        assert a["depth_values"].dtype == b["depth_values"].dtype
        for s in ("stage1", "stage2", "stage3"):
            np.testing.assert_allclose(a["proj_matrices"][s], b["proj_matrices"][s], rtol=1e-6, atol=0)
    if "inverse_depth" in CASES[case]:
        dv = ours[0]["depth_values"]
        step = np.diff(1.0 / dv.astype(np.float64))  # uniform in 1/d, far to near, within [2, 10)
        assert 2.0 <= dv.min() and dv.max() < 10.0
        np.testing.assert_allclose(step, step[0], rtol=1e-4)
        assert step[0] > 0


def test_infer_cli_tnt(tnt_root, sizes, tmp_path):
    """``--dataset tnt --inverse_depth --bucket_hw``: one depth map per
    reference view, at the bucket's size."""
    (tmp_path / "list.txt").write_text("MiniA\nMiniB\n")
    ckpt = tmp_path / "m.ckpt"
    model = TransMVSNet(ModelConfig(ndepths=(16, 8, 8)), device="cpu", generator=torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, ckpt)
    infer.main(["--dataset", "tnt", "--datapath", tnt_root, "--testlist", str(tmp_path / "list.txt"),
                "--outdir", str(tmp_path / "out"), "--loadckpt", str(ckpt), "--num_view", "3",
                "--numdepth", "16", "--ndepths", "16,8,8", "--inverse_depth", "--bucket_hw", "64,96",
                "--batch_size", "2", "--device", "cpu"])
    for scan, views in (("MiniA", 4), ("MiniB", 3)):
        for v in range(views):
            depth, _ = read_pfm(str(tmp_path / f"out/{scan}/depth_est/{v:0>8}.pfm"))
            assert depth.shape == (64, 96) and np.isfinite(depth).all()
        assert (tmp_path / f"out/{scan}/pair.txt").is_file()
