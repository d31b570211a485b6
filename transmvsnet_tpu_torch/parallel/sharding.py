"""Parallelism across processes: the JAX package's ``parallel/
sharding.py`` in torch.distributed.

The JAX package annotates the model's tensors with logical axes
(``constrain``) and GSPMD inserts the collectives. Here the model calls,
at the same points, differentiable ops bound to the axes of the active
``parallel/mesh.py::Mesh`` (``sharding_rules(mesh)``, the JAX package's
context of the same name): ``split`` takes this process's contiguous
chunk of a replicated tensor, ``gather`` concatenates the chunks,
``psum`` sums over the axes and ``pmax`` takes the maximum over them.
Each is the identity when its axes hold one process or no mesh is
active. Their backward passes are the adjoints: ``split``'s is local,
``gather``'s sums the gradients over the axis and keeps this process's
chunk, ``psum``'s sums, ``pmax``'s sums and hands the sum to the
processes that hold the maximum. Chunks are contiguous and as even as
can be (the first ``n % parts`` one larger); ``gather`` pads them to the
largest for the collective and trims them after, as GSPMD pads uneven
shards. Every collective is counted (``parallel/collectives.py``). The
active mesh is a module global, not a context variable, because
autograd's device thread runs the backward (and remat's recompute).

``replicate`` broadcasts rank 0's parameters and buffers to every process
and wraps the model in ``DistributedDataParallel`` over all processes,
which averages the gradients in the backward. With a mesh that is the
gradient of the global batch: every process of a data group computes
the same loss (the model's outputs are replicated over view and depth),
so averaging over all ``D*V*Z`` processes is summing the model-parallel
processes' partial gradients and averaging over the ``D`` data groups,
the JAX package's rule, by linearity. BatchNorm keeps its buffers equal
across processes itself (``models/blocks.py::BatchNorm`` reduces its
batch statistics over its group), so DDP does not broadcast them before
each forward. ``shard_batch`` has no counterpart: each process's loader
already holds its data group's local batch (``data/loader.py``).

``unwrap`` gives back the model itself, whose ``state_dict`` keeps the
reference checkpoint's keys (DDP's own adds ``module.``).
"""

from __future__ import annotations

import contextlib
import inspect

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from transmvsnet_tpu_torch.parallel import collectives, distributed
from transmvsnet_tpu_torch.parallel.mesh import Mesh

_MESH: Mesh | None = None


@contextlib.contextmanager
def sharding_rules(mesh: Mesh):
    """Run the model split over ``mesh`` inside the block."""
    global _MESH
    previous, _MESH = _MESH, mesh
    try:
        yield
    finally:
        _MESH = previous


def axis_size(*axes: str) -> int:
    return 1 if _MESH is None else _MESH.size(*axes)


def chunk_sizes(n: int, parts: int) -> list[int]:
    """Contiguous chunks of ``n`` over ``parts`` processes, the first
    ``n % parts`` one larger."""
    if parts > n:
        raise ValueError(f"cannot split {n} over {parts} processes")
    q, r = divmod(n, parts)
    return [q + (i < r) for i in range(parts)]


def chunk(n: int, axis: str) -> tuple[int, int]:
    """(start, length) of this process's chunk of ``n`` over ``axis``."""
    if axis_size(axis) == 1:
        return 0, n
    sizes = chunk_sizes(n, axis_size(axis))
    i = _MESH.index(axis)
    return sum(sizes[:i]), sizes[i]


def split(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """This process's chunk of ``x`` along ``dim`` over ``axis``."""
    start, length = chunk(x.shape[dim], axis)
    return x if length == x.shape[dim] else x.narrow(dim, start, length)


def reduction_group(axes: tuple[str, ...]):
    """The group a reduction over ``axes`` runs in: the active mesh's
    group of those axes; without a mesh, every process (all are on
    ``data``); None in a single process."""
    if distributed.world_size() == 1:
        return None
    return dist.group.WORLD if _MESH is None else _MESH.group(*axes)


def _contiguous_copy(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, sizes, index, site):
        ctx.dim, ctx.group, ctx.sizes, ctx.index, ctx.site = dim, group, sizes, index, site
        pad = max(sizes) - x.shape[dim]
        if pad:
            x = torch.cat([x, x.new_zeros(*x.shape[:dim], pad, *x.shape[dim + 1:])], dim)
        parts = collectives.all_gather(x, group, site)
        return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim)

    @staticmethod
    def backward(ctx, grad):
        grad = collectives.all_reduce(_contiguous_copy(grad), ctx.group, ctx.site + ".grad")
        start = sum(ctx.sizes[:ctx.index])
        return grad.narrow(ctx.dim, start, ctx.sizes[ctx.index]), None, None, None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, site):
        ctx.group, ctx.site = group, site
        return collectives.all_reduce(_contiguous_copy(x), group, site)

    @staticmethod
    def backward(ctx, grad):
        return collectives.all_reduce(_contiguous_copy(grad), ctx.group, ctx.site + ".grad"), None, None


class _Max(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, site):
        ctx.group, ctx.site = group, site
        y = collectives.all_reduce(_contiguous_copy(x), group, site, op=dist.ReduceOp.MAX)
        ctx.save_for_backward(x == y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (holds,) = ctx.saved_tensors
        # The summed gradient, shared by the processes that hold the
        # maximum (as torch.amax shares it between equal elements).
        both = collectives.all_reduce(torch.stack([grad, holds.to(grad.dtype)]), ctx.group, ctx.site + ".grad")
        return torch.where(holds, both[0] / both[1], torch.zeros_like(grad)), None, None


def gather(x: torch.Tensor, dim: int, axis: str, total: int, site: str) -> torch.Tensor:
    """The chunks of ``total`` that ``split`` gave the processes on
    ``axis``, concatenated along ``dim``."""
    parts = axis_size(axis)
    if parts == 1:
        return x
    return _Gather.apply(x, dim, _MESH.group(axis), chunk_sizes(total, parts), _MESH.index(axis), site)


def sum_over(x: torch.Tensor, group, site: str) -> torch.Tensor:
    """``x`` summed over ``group``."""
    return _Sum.apply(x, group, site)


def psum(x: torch.Tensor, axes: tuple[str, ...], site: str) -> torch.Tensor:
    """``x`` summed over the processes of ``axes``."""
    return x if axis_size(*axes) == 1 else sum_over(x, _MESH.group(*axes), site)


def pmax(x: torch.Tensor, axis: str, site: str) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the processes of ``axis``."""
    return x if axis_size(axis) == 1 else _Max.apply(x, _MESH.group(axis), site)


def _counted_mean_hook(_, bucket):
    """DDP's default gradient reduction (the bucket divided by the number
    of processes, then summed over them), through the counted
    collectives."""
    grads = bucket.buffer().div_(dist.get_world_size())
    return collectives.all_reduce_async(grads, None, "ddp").then(lambda fut: fut.value()[0])


def replicate(model: nn.Module) -> nn.Module:
    """``model`` wrapped for data parallelism when a process group exists
    (world size 1 included, so that the backend's path runs), else
    ``model`` itself."""
    if not distributed.is_initialized():
        return model
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            collectives.broadcast(t, 0, "replicate")
    device = next(model.parameters()).device
    # Newer torch names the switch forward_sync_buffers (broadcast_buffers
    # is deprecated there); both leave the buffers to BatchNorm.
    params = inspect.signature(DistributedDataParallel.__init__).parameters
    sync = {"forward_sync_buffers": False} if "forward_sync_buffers" in params else {"broadcast_buffers": False}
    ddp = DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None, **sync
    )
    ddp.register_comm_hook(None, _counted_mean_hook)
    return ddp


def unwrap(model: nn.Module) -> nn.Module:
    return model.module if isinstance(model, DistributedDataParallel) else model
