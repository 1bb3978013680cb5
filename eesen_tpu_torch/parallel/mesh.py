"""The data-parallel mesh (counterpart of eesen_tpu/parallel/mesh.py).

The reference trained with N independent jobs that averaged their models
through the file system (src/net/communicator.h; steps/
train_ctc_parallel_h.sh).  The JAX package runs one SPMD program over a
`jax.sharding.Mesh` with axes `data` and `model`.  Here a mesh is the
`data` axis of a `torch.distributed` process group: one process (rank) a
shard of every batch, on its own device, the gradients summed over the
group each step.

The carrier is a small dataclass, not `torch.distributed.device_mesh`:
the port has one axis, and `init_device_mesh` starts a default process
group where none exists, while a mesh of one process needs none (as the
JAX package's single-process mesh needs no coordinator).  The mesh names
its rank's device, so two ranks can share one card (over gloo).

The `model` axis (tensor parallelism over the LSTM cell) is not ported:
kernels 1 and 3 keep a direction's whole W_m in one thread-block
cluster, and a recurrence split over H across cards would need an
all-gather of m at every step, which no kernel of the port takes
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

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
    """This process's place on the `data` axis: `data` ranks in all, this
    one `rank`, its tensors on `device`; `group` is the process group (None:
    the default group, or no group at all in a world of one)."""
    data: int
    rank: int
    device: torch.device
    group: Any = None


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """The process's index on its host (`torchrun`'s LOCAL_RANK, else 0)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def make_mesh(
    cfg: MeshConfig = MeshConfig(), device=None, group=None,
) -> Mesh:
    """The mesh of the process group `group` (the default one): its world
    size and this rank, on `device` (`cuda:{LOCAL_RANK}` unless the caller
    names one, "cpu" for the plain versions).  Without a process group the
    world is this process alone.  `cfg.model > 1` raises
    NotImplementedError."""
    if cfg.model > 1:
        raise NotImplementedError(
            "the model axis is not ported: kernels 1 and 3 keep a "
            "direction's whole W_m in one cluster (ROADMAP.md, queue 1)"
        )
    if initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        world, rank = 1, 0
    r = cfg.resolve(world)
    if device is None:
        device = f"cuda:{local_rank()}"
    return Mesh(r.data, rank, check_device(device), group)
