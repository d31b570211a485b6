"""Data parallelism across processes: the JAX package's
``parallel/sharding.py`` (``replicate``, ``shard_batch``) in
torch.distributed.

``replicate`` broadcasts rank 0's parameters and buffers to every process
and wraps the model in ``DistributedDataParallel``, which averages the
gradients over the processes in the backward. BatchNorm keeps its buffers
equal across processes itself (``models/blocks.py::BatchNorm`` reduces its
batch statistics over the process group), so DDP does not broadcast them
before each forward. ``shard_batch`` has no counterpart: each process's
loader already holds its local batch (``data/loader.py``, one shard per
process), where the JAX package assembles one global array from the
processes' slices.

``unwrap`` gives back the model itself, whose ``state_dict`` keeps the
reference checkpoint's keys (DDP's own adds ``module.``).
"""

from __future__ import annotations

import inspect

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from transmvsnet_tpu_torch.parallel import distributed


def replicate(model: nn.Module) -> nn.Module:
    """``model`` wrapped for data parallelism when a process group exists
    (world size 1 included, so that the backend's path runs), else
    ``model`` itself."""
    if not distributed.is_initialized():
        return model
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t, src=0)
    device = next(model.parameters()).device
    # Newer torch names the switch forward_sync_buffers (broadcast_buffers
    # is deprecated there); both leave the buffers to BatchNorm.
    params = inspect.signature(DistributedDataParallel.__init__).parameters
    sync = {"forward_sync_buffers": False} if "forward_sync_buffers" in params else {"broadcast_buffers": False}
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None, **sync
    )


def unwrap(model: nn.Module) -> nn.Module:
    return model.module if isinstance(model, DistributedDataParallel) else model
