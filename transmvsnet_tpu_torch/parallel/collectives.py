"""Every collective of the model and the trainer, counted.

The role the JAX package's ``parallel/hlo_analysis.py`` plays for GSPMD's
lowering: how many bytes each kind of collective moves, and where. There
the partitioner places the collectives and the analysis reads them from
the compiled program; here the port places them itself
(``parallel/sharding.py``), so each goes through one of the functions
below, which add its output's bytes (per process: the reduced buffer, the
gathered tensor, the broadcast buffer, as ``collective_bytes`` counts
HLO outputs) and one call to the count of its kind and call site.
``reset`` and ``read`` work like the kernels' launch counters.

The counts are kept under a lock: the backward runs on autograd's device
thread on CUDA, and DDP's gradient hook on its reducer's.
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_gather", "broadcast")
_lock = threading.Lock()
_sites: dict[tuple[str, str], list[int]] = {}  # (kind, site) -> [calls, bytes, largest call's bytes]


def _count(kind: str, site: str, nbytes: int) -> None:
    with _lock:
        entry = _sites.setdefault((kind, site), [0, 0, 0])
        entry[0] += 1
        entry[1] += nbytes
        entry[2] = max(entry[2], nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def reset() -> None:
    with _lock:
        _sites.clear()


def read() -> dict:
    """{"bytes": {kind: n}, "calls": {kind: n}, "sites": {site: {kind:
    {"calls", "bytes", "largest"}}}} since the last ``reset``."""
    with _lock:
        out = {"bytes": dict.fromkeys(KINDS, 0), "calls": dict.fromkeys(KINDS, 0), "sites": {}}
        for (kind, site), (calls, nbytes, largest) in sorted(_sites.items(), key=lambda kv: kv[0][::-1]):
            out["bytes"][kind] += nbytes
            out["calls"][kind] += calls
            out["sites"].setdefault(site, {})[kind] = {"calls": calls, "bytes": nbytes, "largest": largest}
        return out


def all_reduce(t: torch.Tensor, group, site: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over ``group``; returns ``t``."""
    _count("all_reduce", site, _nbytes(t))
    dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_async(t: torch.Tensor, group, site: str) -> torch.futures.Future:
    """``t`` summed in place over ``group``; a future of ``[t]``."""
    _count("all_reduce", site, _nbytes(t))
    return dist.all_reduce(t, group=group, async_op=True).get_future()


def all_gather(t: torch.Tensor, group, site: str) -> list[torch.Tensor]:
    """Every process's ``t`` (equal shapes), in group rank order."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _count("all_gather", site, _nbytes(t) * len(out))
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def broadcast(t: torch.Tensor, src: int, site: str, group=None) -> torch.Tensor:
    _count("broadcast", site, _nbytes(t))
    dist.broadcast(t, src=src, group=group)
    return t
