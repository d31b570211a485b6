"""The training CLI on a (data 1, view 2, depth 1) mesh of two gloo
processes on the CPU (``--distributed --mesh_view 2``): one epoch of the
synthetic scene (3 views: one source per process, ndepths (8, 8, 8),
float32, remat, the CLI's default), both processes on the same samples
(one data group), rank 0 alone writing. Its checkpoint loads into
``tools/infer.py`` under the reference's keys and the loaded model gives
finite depth. In a file of its own, so that ``--dist loadfile`` gives it a
worker."""

import json

import torch

from test_torch_train_cli_distributed import _train_in_two_processes
from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.data.loader import ShardedLoader
from transmvsnet_tpu_torch.data.synthetic import SyntheticDataset
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet
from transmvsnet_tpu_torch.tools.infer import load_checkpoint
from transmvsnet_tpu_torch.train.loop import to_device_batch


def test_train_cli_on_a_view_mesh_then_infer(tmp_path):
    outs = _train_in_two_processes(tmp_path, "--epochs", "1", "--mesh_view", "2")
    # Four samples in one data group at batch 1: four steps, each logged
    # once, by rank 0 alone; both processes print the same epoch means.
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if r["mode"] == "train"] == [1, 2, 3, 4]
    assert all(r["loss"] == r["loss"] for r in records)
    means = [next(line for line in out.splitlines() if line.startswith("epoch 0 train:")) for out in outs]
    assert means[0] == means[1], means
    ckpt = torch.load(tmp_path / "model_000000.ckpt", map_location="cpu", weights_only=False)
    assert ckpt["step"] == 4
    model = TransMVSNet(ModelConfig(ndepths=(8, 8, 8)), device="cpu")
    assert list(ckpt["model"]) == list(model.state_dict())
    load_checkpoint(model, str(tmp_path / "model_000000.ckpt"))
    initial = TransMVSNet(ModelConfig(ndepths=(8, 8, 8)), device="cpu", generator=torch.Generator().manual_seed(1))
    assert not torch.equal(model.state_dict()["feature.conv0.0.conv.weight"],
                           initial.state_dict()["feature.conv0.0.conv.weight"])  # --seed 1 trained
    raw = next(iter(ShardedLoader(SyntheticDataset(nviews=3, ndepths=48), batch_size=1, num_workers=0)))
    batch = to_device_batch(raw, torch.device("cpu"))
    model.eval()
    with torch.no_grad():
        depth = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])["depth"]
    assert depth.shape == batch["imgs"].shape[:1] + batch["imgs"].shape[2:4] and torch.isfinite(depth).all()
