"""The port's training CLI for one epoch on the CPU, and its resume: the
synthetic scene, float32, 3 views, ndepths (16, 8, 8). In a file of its
own, so that the test runner can give it a worker beside
``tests/test_torch_train.py``.
"""

import json

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs six workers at once, and torch's intra-op threads
    then wait on one another at every op (``tests/test_torch_tnt.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_cli_one_epoch_on_cpu_and_resume(tmp_path):
    from transmvsnet_tpu_torch.tools import train

    args = ["--dataset", "synthetic", "--device", "cpu", "--dtype", "float32", "--nviews", "3",
            "--ndepths", "16,8,8", "--numdepth", "48", "--batch_size", "2", "--logdir", str(tmp_path),
            "--summary_freq", "1"]
    state = train.main(args + ["--epochs", "1"])
    assert state.step == 2  # four synthetic samples, batch 2
    assert (tmp_path / "model_000000.ckpt").exists()
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    modes = {r["mode"] for r in records}
    assert {"train", "train_epoch", "val", "val_epoch"} <= modes
    assert all(np.isfinite(r["loss"]) for r in records)
    state = train.main(args + ["--epochs", "2", "--resume"])
    assert state.step == 4 and (tmp_path / "model_000001.ckpt").exists()
