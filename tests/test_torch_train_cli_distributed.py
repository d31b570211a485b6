"""The training CLI in two processes on the CPU (``--distributed --device
cpu``, gloo): one epoch of the synthetic scene (3 views, ndepths (8, 8, 8),
float32, batch 1 per process), then ``--resume`` for a second. Rank 0
alone writes the metrics and the checkpoints, whose keys are the
reference's (no ``module.``). In a file of its own, so that ``--dist
loadfile`` gives it a worker."""

import json
import os
import socket
import subprocess
import sys

import torch

from transmvsnet_tpu_torch.config import ModelConfig
from transmvsnet_tpu_torch.models.transmvsnet import TransMVSNet

ARGS = ["--dataset", "synthetic", "--device", "cpu", "--dtype", "float32", "--nviews", "3", "--ndepths", "8,8,8",
        "--numdepth", "48", "--batch_size", "1", "--summary_freq", "1", "--distributed", "--num_processes", "2"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _train_in_two_processes(logdir, *extra) -> list[str]:
    coordinator = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"  # six test workers share the machine
    procs = [
        subprocess.Popen([sys.executable, "-m", "transmvsnet_tpu_torch.tools.train", *ARGS, "--logdir", str(logdir),
                          "--coordinator", coordinator, "--process_id", str(pid), *extra],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
    return outs


def test_train_cli_in_two_processes_and_resume(tmp_path):
    _train_in_two_processes(tmp_path, "--epochs", "1")
    # Four samples over two processes at batch 1: two steps and two
    # validation batches, each logged once, by rank 0 alone.
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    by_mode = {m: [r for r in records if r["mode"] == m] for m in ("train", "train_epoch", "val", "val_epoch")}
    assert [r["step"] for r in by_mode["train"]] == [1, 2]
    assert len(by_mode["train_epoch"]) == len(by_mode["val_epoch"]) == 1 and len(by_mode["val"]) == 2
    assert all(r["loss"] == r["loss"] for r in records)
    ckpt = torch.load(tmp_path / "model_000000.ckpt", map_location="cpu", weights_only=False)
    assert ckpt["step"] == 2 and ckpt["epoch"] == 0
    want = TransMVSNet(ModelConfig(ndepths=(8, 8, 8)), device="cpu").state_dict()
    assert list(ckpt["model"]) == list(want)

    outs = _train_in_two_processes(tmp_path, "--epochs", "2", "--resume")
    for out in outs:
        assert "resumed from epoch 0 (step 2)" in out, out[-2000:]
    ckpt = torch.load(tmp_path / "model_000001.ckpt", map_location="cpu", weights_only=False)
    assert ckpt["step"] == 4 and ckpt["epoch"] == 1
    assert sorted(p.name for p in tmp_path.glob("*.ckpt")) == ["model_000000.ckpt", "model_000001.ckpt"]
