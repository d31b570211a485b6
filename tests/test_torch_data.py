"""The port's own numpy copies of the data code against the JAX package's:
the same files and scans give the same samples, and PFM files written by
either side read back identically on the other."""

import numpy as np
import pytest

from transmvsnet_tpu.data import cams as jcams
from transmvsnet_tpu.data import pfm as jpfm
from transmvsnet_tpu.data.datasets import GeneralEvalDataset as JaxGeneralEvalDataset
from transmvsnet_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from transmvsnet_tpu_torch.data import cams, pfm
from transmvsnet_tpu_torch.data.datasets import GeneralEvalDataset
from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset


def _assert_same_sample(ours, theirs):
    np.testing.assert_array_equal(ours["imgs"], theirs["imgs"])
    np.testing.assert_array_equal(ours["depth_values"], theirs["depth_values"])
    assert ours["filename"] == theirs["filename"]
    for s in ("stage1", "stage2", "stage3"):
        np.testing.assert_array_equal(ours["proj_matrices"][s], theirs["proj_matrices"][s])


def test_synthetic_sample_matches_jax():
    kw = dict(nviews=3, num_samples=2, height=32, width=48, ndepths=24)
    ours, theirs = SyntheticDataset(**kw), JaxSyntheticDataset(**kw)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        _assert_same_sample(ours[i], theirs[i])


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """The same scene materialised by each package."""
    root = tmp_path_factory.mktemp("scans")
    kw = dict(nviews=4, num_samples=1, height=64, width=96, ndepths=48)
    SyntheticDataset(**kw).materialize(str(root / "ours"))
    JaxSyntheticDataset(**kw).materialize(str(root / "theirs"))
    return root / "ours", root / "theirs"


def test_materialize_writes_the_same_files(scans):
    ours, theirs = scans
    names = sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    assert len(names) == 9  # 4 images, 4 cams, pair.txt
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name


@pytest.mark.parametrize("nviews", [3, 6])  # 6 > the scan's 4 views: source views are padded
def test_general_eval_sample_matches_jax(scans, nviews):
    ours, _ = scans
    kw = dict(nviews=nviews, ndepths=48, max_h=48, max_w=80)
    a = GeneralEvalDataset(str(ours), ["synth0"], **kw)
    b = JaxGeneralEvalDataset(str(ours), ["synth0"], **kw)
    assert len(a) == len(b) == 4
    for i in (0, 3):
        sample = a[i]
        assert sample["imgs"].shape == (nviews, 32, 64, 3)  # snapped to multiples of 32
        _assert_same_sample(sample, b[i])


def test_cam_file_with_depth_count(tmp_path):
    """A 4-token depth line re-derives the interval from (min, num, interval)."""
    pair = np.zeros((2, 4, 4), np.float32)
    pair[0] = np.eye(4)
    pair[0, :3, 3] = [0.5, -1.0, 2.0]
    pair[1, :3, :3] = [[800.0, 0, 400], [0, 810.0, 300], [0, 0, 1]]
    path = tmp_path / "cam.txt"
    cams.write_cam_file(str(path), pair, depth_line="425.0 2.5 192 905.0")
    ours = cams.read_cam_file(str(path), interval_scale=1.06, ndepths=128)
    theirs = jcams.read_cam_file(str(path), "eval", interval_scale=1.06, ndepths=128)
    np.testing.assert_array_equal(ours.intrinsics, theirs.intrinsics)
    np.testing.assert_array_equal(ours.extrinsics, theirs.extrinsics)
    assert (ours.depth_min, ours.depth_interval) == (theirs.depth_min, theirs.depth_interval)
    np.testing.assert_array_equal(ours.proj_pair(), theirs.proj_pair())


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3)])
def test_pfm_round_trips_between_packages(tmp_path, shape):
    img = np.random.RandomState(0).randn(*shape).astype(np.float32)
    pfm.save_pfm(str(tmp_path / "a.pfm"), img)
    jpfm.save_pfm(str(tmp_path / "b.pfm"), img)
    assert (tmp_path / "a.pfm").read_bytes() == (tmp_path / "b.pfm").read_bytes()
    np.testing.assert_array_equal(jpfm.read_pfm(str(tmp_path / "a.pfm"))[0], img)
    np.testing.assert_array_equal(pfm.read_pfm(str(tmp_path / "b.pfm"))[0], img)
    with pytest.raises(ValueError, match="float32"):
        pfm.save_pfm(str(tmp_path / "c.pfm"), img.astype(np.float64))
