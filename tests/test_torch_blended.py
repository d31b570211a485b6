"""BlendedMVS finetuning data: the port's ``BlendedTrainDataset`` against the
JAX package's on a small seeded BlendedMVS tree written here (two scans of
96x128 JPEGs written by PIL, "bld" cams whose depth line is min, interval,
count, max, ``cams/pair.txt`` with a reference that has too few sources,
PFM depths partly outside the hypothesis range), and the training CLI's
``--dataset blended --loss bld`` on the same tree on the CPU."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_train_data import _write_cam, assert_same_training_sample
from transmvsnet_tpu.data.datasets import BlendedTrainDataset as JaxBlendedTrainDataset
from transmvsnet_tpu.data.pfm import save_pfm
from transmvsnet_tpu_torch.data.datasets import BlendedTrainDataset
from transmvsnet_tpu_torch.data.registry import get_dataset

H, W = 96, 128
DEPTH_MIN, DEPTH_MAX = 2.0, 10.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs six workers at once; torch's intra-op threads would
    wait on one another at every op (``tests/test_torch_tnt.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def blended_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("blended")
    rng = np.random.RandomState(7)
    # Views 0-3 each list three sources; view 4 lists two and is skipped at 4 views.
    pairs = "5\n0\n3 1 9.0 2 8.0 3 7.0\n1\n3 0 9.0 2 8.0 4 5.0\n2\n3 3 9.0 1 8.0 0 7.0\n" \
            "3\n3 2 9.0 4 8.0 1 7.0\n4\n2 3 9.0 2 8.0\n"
    for scan in ("5a3cb4e4270f0e3a1bf8ab3e", "5b08286b2775267d5b0634ba"):
        for sub in ("blended_images", "cams", "rendered_depth_maps"):
            (root / scan / sub).mkdir(parents=True)
        (root / scan / "cams/pair.txt").write_text(pairs)
        for v in range(5):
            yy, xx = np.mgrid[0:H, 0:W]
            img = np.stack([(xx * 2 + v * 9) % 256, (yy * 3) % 256, (xx + yy) % 256], -1).astype(np.uint8)
            img = np.clip(img.astype(int) + rng.randint(-20, 20, img.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / scan / f"blended_images/{v:0>8}.jpg", quality=90)
            _write_cam(root / scan / f"cams/{v:0>8}_cam.txt", rng,
                       f"{DEPTH_MIN} {(DEPTH_MAX - DEPTH_MIN) / 192:.6f} 192 {DEPTH_MAX}")
            depth = rng.uniform(DEPTH_MIN - 1.0, DEPTH_MAX + 1.0, (H, W)).astype(np.float32)
            save_pfm(str(root / scan / f"rendered_depth_maps/{v:0>8}.pfm"), depth)
    (root / "list.txt").write_text("5a3cb4e4270f0e3a1bf8ab3e\n5b08286b2775267d5b0634ba\n")
    return root


@pytest.mark.parametrize("nviews,ndepths", [(4, 192), (3, 48)])
def test_blended_samples_match_jax(blended_tree, nviews, ndepths):
    kw = dict(datapath=str(blended_tree), listfile=str(blended_tree / "list.txt"), nviews=nviews, ndepths=ndepths)
    ours, theirs = BlendedTrainDataset(**kw, device="cpu"), JaxBlendedTrainDataset(**kw)
    assert ours.metas == theirs.metas
    assert len(ours) == (8 if nviews == 4 else 10)
    for idx in (0, len(ours) - 1):
        a, b = ours[idx], theirs[idx]
        assert_same_training_sample(a, b)
        assert a["imgs"].shape == (nviews, H, W, 3)
        assert a["depth_values"].shape == (ndepths,)
        assert a["depth"]["stage1"].shape == a["mask"]["stage1"].shape == (H // 4, W // 4)
        assert 0 < a["mask"]["stage3"].mean() < 1


def test_registry_names_match_jax():
    from transmvsnet_tpu.data import registry as jax_registry
    from transmvsnet_tpu_torch.data import registry

    assert sorted(registry.DATASETS) == sorted(jax_registry._REGISTRY)
    for name, cls in registry.DATASETS.items():
        assert cls.__name__ == jax_registry.get_dataset(name).__name__, name
    assert get_dataset("blended") is get_dataset("bld_train") is BlendedTrainDataset
    with pytest.raises(KeyError, match="available"):
        get_dataset("eth3d")


def test_finetune_cli_on_cpu(blended_tree, tmp_path):
    """The reference's finetune recipe (``--dataset blended --loss bld``) at
    a tiny size: one epoch, with the EPE metrics logged."""
    from transmvsnet_tpu_torch.tools import train

    lst = tmp_path / "one_scan.txt"
    lst.write_text("5a3cb4e4270f0e3a1bf8ab3e\n")
    state = train.main(["--dataset", "blended", "--loss", "bld", "--device", "cpu", "--datapath", str(blended_tree),
                        "--trainlist", str(lst), "--testlist", str(lst), "--nviews", "3", "--ndepths", "8,8,8",
                        "--numdepth", "48", "--batch_size", "2", "--lr", "2e-4", "--epochs", "1",
                        "--summary_freq", "1", "--logdir", str(tmp_path)])
    assert state.step == 2  # five samples of three views, batch 2, the last batch dropped
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    for r in records:
        assert {"epe", "less1", "less3", "loss"} <= set(r), r["mode"]
        assert np.isfinite(r["loss"]) and np.isfinite(r["epe"])
    assert (tmp_path / "model_000000.ckpt").exists()
