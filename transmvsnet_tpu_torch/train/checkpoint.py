"""Checkpoints in the reference's ``.ckpt`` layout (reference
train.py:84-90,332-347).

``save_checkpoint`` writes ``<logdir>/model_{epoch:0>6}.ckpt`` with
``{"epoch", "model", "optimizer", "scheduler", "step"}``: ``model`` is the
state dict under the reference checkpoint's keys, so
``tools/infer.py::load_checkpoint`` and the reference load it as it is.
``restore_latest`` resumes from the highest epoch in a directory; the
weights-only ``--loadckpt`` path is ``tools/infer.py::load_checkpoint``.
Across processes rank 0 alone writes, then every process waits for it
(the file is whole before any process reads it); every process restores
from the same file. A model wrapped for data parallelism is saved and
loaded as the model itself, under the reference's keys.
"""

from __future__ import annotations

import glob
import os
import re

import torch

from transmvsnet_tpu_torch.parallel import distributed
from transmvsnet_tpu_torch.parallel.sharding import unwrap
from transmvsnet_tpu_torch.train.step import TrainState

_NAME = re.compile(r"model_(\d+)\.ckpt$")


def checkpoint_path(logdir: str, epoch: int) -> str:
    return os.path.join(logdir, f"model_{epoch:0>6}.ckpt")


def save_checkpoint(logdir: str, epoch: int, state: TrainState) -> str:
    path = checkpoint_path(logdir, epoch)
    if distributed.is_main():
        os.makedirs(logdir, exist_ok=True)
        torch.save(
            {
                "epoch": epoch,
                "model": unwrap(state.model).state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(),
                "step": state.step,
            },
            path,
        )
    distributed.barrier()
    return path


def latest_checkpoint(logdir: str) -> str | None:
    found = [(int(m.group(1)), p) for p in glob.glob(os.path.join(logdir, "model_*.ckpt"))
             if (m := _NAME.search(p))]
    return max(found)[1] if found else None


def restore_latest(logdir: str, state: TrainState) -> int | None:
    """Load the latest checkpoint of ``logdir`` into ``state`` (model,
    optimizer, schedule, global step); returns its epoch, or None if there
    is none."""
    path = latest_checkpoint(logdir)
    if path is None:
        return None
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    unwrap(state.model).load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"])

