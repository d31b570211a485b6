"""The port's training data against the JAX package's: the synthetic
training sample, the cam conventions and ``DTUTrainDataset`` on a small
fake DTU training tree (Cameras/pair.txt, train cams, Rectified PNGs,
Depths_raw PFM depth and PNG visibility mask), the numpy nearest resize
that stands in for ``cv2.resize(INTER_NEAREST)``, and the loader's shards
of the index space. BlendedMVS is in ``tests/test_torch_blended.py``."""

import cv2
import numpy as np
import pytest

from transmvsnet_tpu.data import cams as jcams
from transmvsnet_tpu.data.datasets import DTUTrainDataset as JaxDTUTrainDataset
from transmvsnet_tpu.data.loader import ShardedLoader as JaxShardedLoader
from transmvsnet_tpu.data.pfm import save_pfm
from transmvsnet_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from transmvsnet_tpu_torch.data import cams
from transmvsnet_tpu_torch.data.datasets import DTUTrainDataset, resize_nearest
from transmvsnet_tpu_torch.data.loader import ShardedLoader
from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset

STAGES = ("stage1", "stage2", "stage3")


def assert_same_training_sample(ours, theirs):
    for key in ("imgs", "depth_values"):
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    assert ours["depth_interval"] == theirs["depth_interval"]
    assert ours["depth_interval"].dtype == theirs["depth_interval"].dtype
    for s in STAGES:
        for key in ("proj_matrices", "depth", "mask"):
            np.testing.assert_array_equal(ours[key][s], theirs[key][s], err_msg=f"{key} {s}")
            assert ours[key][s].dtype == theirs[key][s].dtype


def test_synthetic_training_sample_matches_jax():
    kw = dict(nviews=3, num_samples=2, height=32, width=64, ndepths=48)
    ours, theirs = SyntheticDataset(**kw), JaxSyntheticDataset(**kw)
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert_same_training_sample(a, b)
        assert a["depth"]["stage1"].shape == (8, 16) and a["mask"]["stage3"].all()


@pytest.mark.parametrize("shape,size", [((32, 64), (16, 8)), ((1200, 1600, 3), (800, 600)), ((37, 53), (9, 18))])
def test_resize_nearest_matches_cv2(shape, size):
    arr = np.random.RandomState(0).rand(*shape).astype(np.float32)
    want = cv2.resize(arr, size, interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(resize_nearest(arr, *size), want)


def _write_cam(path, rng, depth_line):
    pair = np.zeros((2, 4, 4), np.float32)
    pair[0] = np.eye(4)
    pair[0, :3, 3] = rng.randn(3) * 10
    pair[1, :3, :3] = [[361.5, 0, 82.9], [0, 360.4, 66.4], [0, 0, 1]]
    jcams.write_cam_file(str(path), pair, depth_line=depth_line)


def test_cam_conventions_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    _write_cam(tmp_path / "train.txt", rng, "425.0 2.5")
    _write_cam(tmp_path / "eval.txt", rng, "425.0 2.5 192 905.0")
    for name, conv in (("train.txt", "dtu_train"), ("eval.txt", "eval")):
        ours = cams.read_cam_file(str(tmp_path / name), interval_scale=1.06, convention=conv)
        theirs = jcams.read_cam_file(str(tmp_path / name), conv, interval_scale=1.06)
        np.testing.assert_array_equal(ours.intrinsics, theirs.intrinsics)
        np.testing.assert_array_equal(ours.extrinsics, theirs.extrinsics)
        assert ours.depth_min == theirs.depth_min
        np.testing.assert_allclose(ours.depth_interval, theirs.depth_interval, rtol=1e-12)
    # The default stays the evaluation convention of the port's existing callers.
    default = cams.read_cam_file(str(tmp_path / "eval.txt"))
    assert default.intrinsics[0, 0] == pytest.approx(361.5 / 4)
    # Tanks and Temples' (depth_min, depth_max) line, as the JAX package reads it.
    _write_cam(tmp_path / "minmax.txt", rng, "2.0 10.0")
    ours = cams.read_cam_file(str(tmp_path / "minmax.txt"), ndepths=96, convention="minmax")
    theirs = jcams.read_cam_file(str(tmp_path / "minmax.txt"), "minmax", ndepths=96)
    np.testing.assert_array_equal(ours.intrinsics, theirs.intrinsics)
    np.testing.assert_array_equal(ours.extrinsics, theirs.extrinsics)
    assert (ours.depth_min, ours.depth_interval, ours.depth_max) == (
        theirs.depth_min, theirs.depth_interval, theirs.depth_max)
    # BlendedMVS's (depth_min, interval, num, depth_max) line: max is the last token.
    _write_cam(tmp_path / "bld.txt", rng, "2.0 0.0417 192 10.0")
    ours = cams.read_cam_file(str(tmp_path / "bld.txt"), ndepths=96, convention="bld")
    theirs = jcams.read_cam_file(str(tmp_path / "bld.txt"), "bld", ndepths=96)
    np.testing.assert_array_equal(ours.intrinsics, theirs.intrinsics)
    np.testing.assert_array_equal(ours.extrinsics, theirs.extrinsics)
    assert (ours.depth_min, ours.depth_interval, ours.depth_max) == (
        theirs.depth_min, theirs.depth_interval, theirs.depth_max) == (2.0, 8.0 / 96, 10.0)
    with pytest.raises(ValueError, match="convention"):
        cams.read_cam_file(str(tmp_path / "eval.txt"), convention="unknown")


@pytest.fixture(scope="module")
def dtu_train_tree(tmp_path_factory):
    """Scan "scan1": 3 viewpoints, images of 1296x1040 (so the /2 + centre
    crop to 640x512 cuts 4 px each side); of the 7 lights the samples
    index, only lights 0-2 are written."""
    root = tmp_path_factory.mktemp("dtu_train")
    rng = np.random.RandomState(2)
    (root / "Cameras/train").mkdir(parents=True)
    (root / "Rectified/scan1_train").mkdir(parents=True)
    (root / "Depths_raw/scan1").mkdir(parents=True)
    (root / "Cameras/pair.txt").write_text(
        "3\n0\n2 1 10.0 2 5.0\n1\n2 0 10.0 2 4.0\n2\n2 1 9.0 0 3.0\n"
    )
    H, W = 1040, 1296
    for v in range(3):
        _write_cam(root / f"Cameras/train/{v:0>8}_cam.txt", rng, "425.0 2.5")
        for light in range(3):
            img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / f"Rectified/scan1_train/rect_{v + 1:0>3}_{light}_r5000.png"), img)
        save_pfm(str(root / f"Depths_raw/scan1/depth_map_{v:0>4}.pfm"),
                 (500 + 100 * rng.rand(H, W)).astype(np.float32))
        cv2.imwrite(str(root / f"Depths_raw/scan1/depth_visual_{v:0>4}.png"),
                    (rng.rand(H, W) * 20).astype(np.uint8))
    (root / "train.txt").write_text("scan1\n")
    return root


def test_dtu_train_dataset_matches_jax(dtu_train_tree):
    kw = dict(datapath=str(dtu_train_tree), listfile=str(dtu_train_tree / "train.txt"), nviews=3)
    ours, theirs = DTUTrainDataset(**kw, device="cpu"), JaxDTUTrainDataset(**kw)
    assert len(ours) == len(theirs) == 3 * 7
    assert ours.metas == theirs.metas
    for idx in (0, 9):  # reference views 0 and 1, lights 0 and 2
        a, b = ours[idx], theirs[idx]
        assert_same_training_sample(a, b)
        assert a["imgs"].shape == (3, 512, 640, 3)
        assert a["depth"]["stage1"].shape == a["mask"]["stage1"].shape == (128, 160)
        assert 0 < a["mask"]["stage3"].mean() < 1
    # Batched by the port's loader as the training CLI batches it.
    batch = next(iter(ShardedLoader(ours, batch_size=2, num_workers=0)))
    assert batch["imgs"].shape == (2, 3, 512, 640, 3)
    assert batch["depth"]["stage2"].shape == (2, 256, 320)
    assert batch["depth_interval"].shape == (2,)


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
@pytest.mark.parametrize("n,num_shards", [(10, 1), (10, 2), (10, 3), (7, 4), (5, 5), (2, 4)])
def test_shards_match_jax(n, num_shards, shuffle):
    """Each process's indices and batch count per epoch are the JAX
    loader's: shuffled from seed + epoch, padded by wrapping, every
    num_shards-th index. One shard is the whole epoch in order."""
    for epoch in (0, 3):
        shards = []
        for shard_id in range(num_shards):
            kw = dict(batch_size=2, shuffle=shuffle, num_shards=num_shards, shard_id=shard_id, seed=5, drop_last=True)
            ours, theirs = ShardedLoader(_Sized(n), **kw), JaxShardedLoader(_Sized(n), **kw)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            np.testing.assert_array_equal(ours._shard_indices(), theirs._shard_indices())
            assert len(ours) == len(theirs)
            shards.append(ours._shard_indices())
        if num_shards == 1:
            want = np.arange(n)
            if shuffle:
                np.random.RandomState(5 + epoch).shuffle(want)
            np.testing.assert_array_equal(shards[0], want)
        if num_shards <= n:
            assert len({len(s) for s in shards}) == 1
            assert set(np.concatenate(shards).tolist()) == set(range(n))
