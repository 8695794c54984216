"""A (data, model) layout of the ranks (counterpart of
efficientat_tpu/parallel/mesh.py::make_mesh).

The JAX package lays its devices out as a ``("data", "model")`` mesh,
``devices.reshape(n / model_axis, model_axis)``, and shards member-parallel
ensembles over ``model`` (``parallel/ensemble.py``). Here each device is a
rank of ``torch.distributed``, and rank ``r`` sits at data index
``r // model_axis`` and model index ``r % model_axis``, as device ``r`` does
in the JAX mesh. A rank's data group is the ranks of its model index (one a
data index), its model group the ranks of its data index. The groups are
``torch.distributed.new_group``s over the default group's backend, the one
``parallel/ddp.py::init_from_env`` picked: NCCL when every rank has a card
of its own, gloo otherwise (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's place in a ``(world / model_axis) x model_axis`` layout;
    the groups are None in a single process."""

    rank: int
    world: int
    model_axis: int
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> dict:
        """Axis sizes, as ``jax.sharding.Mesh.shape``."""
        return {"data": self.world // self.model_axis, "model": self.model_axis}

    @property
    def data_index(self) -> int:
        return self.rank // self.model_axis

    @property
    def model_index(self) -> int:
        return self.rank % self.model_axis


def mesh_groups(n: int, model_axis: int) -> Tuple[List[List[int]], List[List[int]]]:
    """The ranks of every data group and every model group of ``n`` ranks."""
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"{n} ranks do not split into a model axis of {model_axis}")
    grid = [list(range(d * model_axis, (d + 1) * model_axis))
            for d in range(n // model_axis)]
    return [list(col) for col in zip(*grid)], grid


def make_mesh(n: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """This rank's place and groups in a ``(n / model_axis) x model_axis``
    layout of the default process group's ``n`` ranks (1 without one). Every
    rank must call it, in the same order as its other collectives."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    n = world if n is None else n
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}: "
                         "lay out every rank of the group")
    data_groups, model_groups = mesh_groups(n, model_axis)
    if not initialized:
        return Mesh(0, 1, model_axis)
    rank = dist.get_rank()
    # new_group is collective over the default group: every rank creates
    # every group, in one order, and keeps its own
    mine = {}
    for axis, groups in (("data", data_groups), ("model", model_groups)):
        for ranks in groups:
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[axis] = group
    return Mesh(rank, world, model_axis, mine["data"], mine["model"])
