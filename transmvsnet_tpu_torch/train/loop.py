"""Training loop pieces: scalar meter, metrics log, one epoch.

The runtime shape of reference train.py:52-118, as the JAX package's
``train/loop.py`` has it: ``run_epoch`` drives a train or eval step over a
loader, averages the scalars with ``DictMeter`` (the reference's
DictAverageMeter, utils.py:119-138) and logs every ``log_freq`` steps to
``MetricsLogger`` (a JSONL file, and TensorBoard where it is installed,
with the first image's depth, confidence, ground truth and error map).
Across processes only rank 0's logger writes; the scalars it logs are
already averaged over the processes (``train/step.py``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from transmvsnet_tpu_torch.parallel import distributed
from transmvsnet_tpu_torch.utils_vis import log_depth_images

BATCH_KEYS = ("imgs", "proj_matrices", "depth_values", "depth", "mask", "depth_interval")


class DictMeter:
    """Running sums of scalars. Device tensors are added on the device, so
    the loop reads nothing back until ``mean()``."""

    def __init__(self):
        self.data: dict[str, Any] = {}
        self.count = 0

    def update(self, scalars: dict[str, Any]) -> None:
        self.count += 1
        for k, v in scalars.items():
            self.data[k] = self.data.get(k, 0.0) + v

    def mean(self) -> dict[str, float]:
        return {k: float(v) / max(self.count, 1) for k, v in self.data.items()}


class MetricsLogger:
    """``<logdir>/metrics.jsonl``, one record per call, plus TensorBoard
    scalars and images when ``torch.utils.tensorboard`` can be imported.
    Writes only on the main process (rank 0); elsewhere every call is a
    no-op and nothing is created."""

    def __init__(self, logdir: str):
        self.enabled = distributed.is_main()
        self._tb = None
        if not self.enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(logdir)

    def log(self, mode: str, scalars: dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        rec = {"mode": mode, "step": step, **{k: float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{mode}/{k}", float(v), step)

    def log_images(self, mode: str, images: dict[str, torch.Tensor], batch: dict[str, Any], step: int) -> None:
        """The step's "_depth_est" and "_confidence" (and the batch's
        ground truth) as TensorBoard images, where TensorBoard is."""
        if self._tb is not None and images:
            log_depth_images(self._tb, mode, images["_depth_est"], images["_confidence"], batch, step)

    def close(self) -> None:
        if not self.enabled:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def to_device_batch(batch: dict[str, Any], device: torch.device) -> dict[str, Any]:
    """A loader batch's model and loss inputs as tensors on ``device``."""

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)

    return {k: conv(batch[k]) for k in BATCH_KEYS if k in batch}


def run_epoch(
    step_fn: Callable,
    state,
    loader: Iterable,
    device: torch.device,
    train: bool = True,
    logger: MetricsLogger | None = None,
    mode: str = "train",
    log_freq: int = 50,
    epoch: int = 0,
):
    """One pass over the loader. Returns (state, epoch-mean scalars)."""
    meter = DictMeter()
    t_last = time.time()
    i_last = -1
    for i, raw in enumerate(loader):
        batch = to_device_batch(raw, device)
        if train:
            state, scalars = step_fn(state, batch)
        else:
            scalars = step_fn(state, batch)
        images = {k: scalars.pop(k) for k in list(scalars) if k.startswith("_")}
        meter.update(scalars)
        if logger and logger.enabled and i % log_freq == 0:
            now = time.time()
            step = state.step if train else epoch
            logger.log(
                mode,
                {**{k: float(v) for k, v in scalars.items()},
                 "sec_per_iter": (now - t_last) / max(i - i_last, 1)},
                step,
            )
            logger.log_images(mode, images, batch, step)
            t_last, i_last = time.time(), i
    return state, meter.mean()
