"""The (data, view, depth) process mesh: the JAX package's
``parallel/mesh.py::make_mesh`` over the processes of a torch.distributed
group instead of the devices of one program.

- ``data``: each group of ``view x depth`` processes trains one replica
  of the model on its own samples; gradients and the replicated
  BatchNorms' statistics reduce over this axis.
- ``view``: the source views of the plane sweep (and of the FMT); the
  view-weighted similarity sum becomes an all-reduce over it.
- ``depth``: the depth-hypothesis slabs of each stage (and the FMT's
  tokens, which the JAX package calls "seq"); the slabs are gathered over
  it before the cost regulariser.

Process ``r`` sits at ``(r // (V*Z), (r // Z) % V, r % Z)``: the JAX
package reshapes its devices row-major into ``(data, view, depth)``. A
mesh that needs more processes than the group has raises ``ValueError``;
one that needs fewer takes the first processes, as the JAX package takes
the first devices, and leaves the rest outside (``coords`` None).

``make_mesh`` creates, on every process and in the same order, one
process group for each set of processes that shares all coordinates but
those of ``AXIS_SETS`` entry; each process keeps its own. A set of axes
whose processes are the whole group uses the default group, and a set of
size 1 has no group (its collectives are no-ops).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch.distributed as dist

from transmvsnet_tpu_torch.config import MeshConfig
from transmvsnet_tpu_torch.parallel import distributed

AXES = ("data", "view", "depth")
# The axis sets the model and the trainer reduce over: each axis alone,
# the model-parallel group (one replica's processes) and the whole mesh.
AXIS_SETS = (("data",), ("view",), ("depth",), ("view", "depth"), AXES)


def coordinates(rank: int, shape: tuple[int, int, int]) -> tuple[int, int, int]:
    """Process ``rank``'s (data, view, depth) coordinates, row-major."""
    _, v, z = shape
    return rank // (v * z), (rank // z) % v, rank % z


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: tuple[int, int, int]
    coords: tuple[int, int, int] | None
    groups: dict

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[AXES.index(a)] for a in axes)

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def group(self, *axes: str):
        """This process's group over ``axes`` (in ``AXES`` order), or None
        when it holds one process."""
        if self.coords is None:
            raise RuntimeError(f"this process (rank {distributed.rank()}) is outside the mesh {self.shape}")
        return self.groups[tuple(a for a in AXES if a in axes)]


def make_mesh(config: MeshConfig | None = None) -> Mesh:
    """The mesh of ``config`` over the current process group (one process
    without a group). No config puts every process on ``data``; a
    ``data`` of 0 takes the processes the other two axes leave
    (at least 1)."""
    world = distributed.world_size()
    if config is None:
        config = MeshConfig(world, 1, 1)
    shape = (config.data or max(1, world // (config.view * config.depth)), config.view, config.depth)
    needed = math.prod(shape)
    if min(shape) < 1 or needed > world:
        raise ValueError(f"mesh {shape} needs {needed} processes, have {world}")
    rank = distributed.rank()
    ranks = np.arange(needed).reshape(shape)
    groups = {}
    for axes in AXIS_SETS:
        dims = [AXES.index(a) for a in axes]
        size = math.prod(shape[d] for d in dims)
        groups[axes] = None
        if size == 1:
            continue
        rest = [d for d in range(3) if d not in dims]
        for members in np.transpose(ranks, rest + dims).reshape(-1, size).tolist():
            group = dist.group.WORLD if size == world else dist.new_group(members)
            if rank in members:
                groups[axes] = group
    return Mesh(shape, coordinates(rank, shape) if rank < needed else None, groups)
