"""The (data, model) mesh (counterpart of eesen_tpu/parallel/mesh.py).

The reference trained with N independent jobs that averaged their models
through the file system (src/net/communicator.h; steps/
train_ctc_parallel_h.sh).  The JAX package runs one SPMD program over a
`jax.sharding.Mesh` with axes `data` and `model`.  Here a mesh is a
(data, model) grid of the ranks of a `torch.distributed` process group,
laid out as JAX's row-major `reshape(data, model)` of its devices: global
rank r sits at data index r // model and model index r % model, on its
own device.

- `data`: a batch splits its rows over it, and the gradients are summed
  over it each step (the ranks that share this rank's model index, its
  data group);
- `model`: each parameter leaf is held as its `leaf_pspec` block over it,
  and the step gathers the whole tree over it (the ranks that share this
  rank's data index, its model group).  As in the JAX package, whose
  shard_map step leaves `model` to XLA, which cannot partition a
  pallas_call and so gathers the weights and runs the whole recurrence on
  every chip of a model group, this is a placement of the parameters, not
  a split recurrence: kernels 1, 3, 6 and 7 run at full width on each
  rank.

The carrier is a small dataclass, not `torch.distributed.device_mesh`:
`init_device_mesh` starts a default process group where none exists,
while a mesh of one process needs none (as the JAX package's
single-process mesh needs no coordinator).  The mesh names its rank's
device, so several ranks can share one card (over gloo).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Tuple

import torch
import torch.distributed as dist

from eesen_tpu_torch.models.model import check_device


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1        # -1: all remaining processes
    model: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        """The sizes for a world of `n_devices` processes (the JAX
        package's arithmetic and message)."""
        model = max(self.model, 1)
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} != device count {n_devices}"
            )
        return MeshConfig(data=data, model=model)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on a `data` x `model` grid: `rank` is its rank
    in `group` (None: the default group, or no group at all in a world of
    one), its tensors live on `device`.  `data_group` / `model_group` are
    the process groups of its data and model axes where an axis is a
    proper part of the world; an axis that spans the whole world runs its
    collectives on `group`, an axis of one rank runs none."""
    data: int
    rank: int
    device: torch.device
    group: Any = None
    model: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def axis(self, name: str) -> Tuple[int, int]:
        """(size, this rank's index) of axis `name`."""
        if name == "data":
            return self.data, self.data_index
        if name == "model":
            return self.model, self.model_index
        raise ValueError(f"a mesh has axes 'data' and 'model', not {name!r}")

    def axis_group(self, name: str) -> Tuple[bool, Any]:
        """(whether a collective over axis `name` runs, its process group).
        None runs where no process group exists, or where the axis holds
        this rank alone in a larger world; an axis that spans the world
        (a data-only mesh's `data`, even in a world of one) runs on
        `group`, as the data-only mesh always has."""
        size, _ = self.axis(name)
        if not initialized():
            return False, None
        if size == self.data * self.model:
            return True, self.group
        if size == 1:
            return False, None
        return True, self.data_group if name == "data" else self.model_group


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """The process's index on its host (`torchrun`'s LOCAL_RANK, else 0)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def _world_ranks(group, world: int) -> List[int]:
    """The global ranks of `group`'s ranks 0..world-1."""
    if group is None:
        return list(range(world))
    return [dist.get_global_rank(group, i) for i in range(world)]


def make_mesh(
    cfg: MeshConfig = MeshConfig(), device=None, group=None,
) -> Mesh:
    """The mesh of the process group `group` (the default one): its world
    size resolved into data x model, and this rank, on `device`
    (`cuda:{LOCAL_RANK}` unless the caller names one, "cpu" for the plain
    versions).  Without a process group the world is this process alone.

    Where both axes have more than one rank, the axes' process groups are
    made here: `model` groups of `data` ranks (one a model index), then
    `data` groups of `model` ranks (one a data index), in that order.
    `dist.new_group` is collective over the default group, so every rank
    of the default group calls make_mesh with the same configuration."""
    if initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        world, rank = 1, 0
    r = cfg.resolve(world)
    if device is None:
        device = f"cuda:{local_rank()}"
    data_group = model_group = None
    if r.data > 1 and r.model > 1:
        ranks = _world_ranks(group, world)
        for m in range(r.model):
            g = dist.new_group(ranks[m::r.model])
            if rank % r.model == m:
                data_group = g
        for d in range(r.data):
            g = dist.new_group(ranks[d * r.model:(d + 1) * r.model])
            if rank // r.model == d:
                model_group = g
    return Mesh(r.data, rank, check_device(device), group, r.model,
                data_group, model_group)
