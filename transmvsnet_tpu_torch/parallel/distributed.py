"""Several processes: the process group, each process's rank and device.

The JAX package's ``parallel/mesh.py::initialize_distributed`` (the
reference's torch.distributed.launch bootstrap, reference
train.py:296-301) in torch.distributed. ``initialize`` takes the
coordinator's ``host:port``, the number of processes and this process's
id, or, where they are not given, torchrun's ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. The backend is NCCL for
CUDA and gloo for the CPU unless the caller names one: gloo also carries
CUDA tensors, which is how two processes share one card (NCCL refuses two
ranks on one device). A backend that cannot start raises; nothing falls
back to another.

A process's card is ``cuda:LOCAL_RANK`` under torchrun and
``cuda:(rank % cards)`` otherwise. Without a process group every query
answers for one process (rank 0 of 1), so single-process code needs no
branch.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    """Whether this process logs and writes checkpoints (rank 0)."""
    return rank() == 0


def _card(process_rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_rank % max(torch.cuda.device_count(), 1)


def process_device(kind: str | torch.device) -> torch.device:
    """This process's device of ``kind``: its card for "cuda", else the CPU."""
    if torch.device(kind).type == "cuda":
        return torch.device("cuda", _card(rank()))
    return torch.device(kind)


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """Join the process group (a no-op when this process already has).

    ``coordinator`` is process 0's ``host:port``; with ``num_processes``
    and ``process_id`` each falls back to torchrun's environment. On CUDA
    the process's card becomes the current device before the group starts.
    """
    if is_initialized():
        return
    env = os.environ
    if coordinator is None:
        coordinator = f"{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    cuda = torch.device(device).type == "cuda"
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        torch.cuda.set_device(_card(process_id))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id)


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()
