"""Multi-process initialization, data sharding and the collectives of the
mesh path (counterpart of eesen_tpu/parallel/distributed.py).

The reference scales across machines with independent processes polling a
shared file system (src/net/communicator.h; utils/run.pl, queue.pl,
slurm.pl).  Here every process is one rank of a `torch.distributed`
process group:

- `init_distributed()` reads `torchrun`'s environment (RANK, WORLD_SIZE,
  MASTER_ADDR, MASTER_PORT, LOCAL_RANK) or takes the coordinator's
  address, the world size and this rank; with neither it does nothing and
  the world is this process alone;
- `host_shard` splits a dataset by rank (utils/distribute_scp.pl);
- `global_batch` places a rank's local rows, which are already its shard
  of the global batch;
- `psum_`, `all_gather` and `barrier` are the collectives the trainer
  and the sharded decoder use, each over a named axis of the mesh (the
  ranks of this rank's data or model group) or, for `barrier`, over the
  whole mesh; without a process group they do nothing.

    torchrun --nproc_per_node=N train.py    # train.py: init_distributed(),
                                            # Trainer(cfg, mesh=make_mesh())
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

from eesen_tpu_torch.parallel.mesh import Mesh, initialized, local_rank
from eesen_tpu_torch.parallel.sharding import batch_pspec, put
from eesen_tpu_torch.utils.logging import get_logger

log = get_logger("parallel.distributed")

T = TypeVar("T")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> None:
    """Join the process group.  `coordinator_address` is rank 0's
    "host:port"; without it the address comes from MASTER_ADDR /
    MASTER_PORT.  The backend is nccl where CUDA is available, else gloo,
    unless the caller names one (two ranks on one card need gloo: NCCL
    refuses a duplicate GPU).  `timeout` (seconds) bounds the rendezvous.
    With no argument and no launcher environment this is a no-op; once
    arguments or an environment are given, a failure raises."""
    if initialized():
        return
    env = os.environ
    if (coordinator_address is None and num_processes is None
            and process_id is None and "WORLD_SIZE" not in env):
        log.info("single process: no coordinator and no launcher")
        return
    world = num_processes if num_processes is not None else env.get(
        "WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("RANK")
    if world is None or rank is None:
        raise ValueError(
            "init_distributed needs the world size and this process's "
            "rank: pass num_processes and process_id, or launch with "
            "torchrun"
        )
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world), rank=int(rank), **kw)
    log.info("distributed: rank %d of %d (%s)", dist.get_rank(),
             dist.get_world_size(), backend)


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def host_shard(items: Sequence[T], rank: Optional[int] = None,
               world: Optional[int] = None) -> List[T]:
    """This process's share of a dataset, round-robin by rank
    (items[rank::world]; the process group's by default)."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    return list(items[rank::world])


def global_batch(local_batch, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A rank's local rows, which are its shard of the global batch, on
    its device (keys outside batch_pspec are dropped)."""
    return {k: put(v, mesh.device) for k, v in local_batch.items()
            if k in batch_pspec()}


def psum_(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """x summed over the ranks of this rank's `axis` group, in place."""
    runs, group = mesh.axis_group(axis)
    if runs:
        dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int = 0,
               axis: str = "data") -> torch.Tensor:
    """The x of every rank of this rank's `axis` group, concatenated in
    axis order along `dim`."""
    runs, group = mesh.axis_group(axis)
    if not runs:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.axis(axis)[0])]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def barrier(mesh: Mesh) -> None:
    """Every rank of the mesh waits for all the others."""
    if initialized():
        dist.barrier(group=mesh.group)
