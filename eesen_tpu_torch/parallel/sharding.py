"""Sharding rules for parameters, optimizer state and batches
(counterpart of eesen_tpu/parallel/sharding.py).

A partition spec is plain data here: a tuple of mesh axis names (or None)
per dimension, so `(None, None, "model")` is `tuple(P(None, None,
"model"))` of the JAX package.  Parameters and optimizer state are
replicated over `data` (a broadcast from rank 0); a batch splits its
leading axis over `data`, each rank taking its contiguous block of rows,
as `jax.device_put` places a `P("data")` array on a mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from eesen_tpu_torch.parallel.mesh import Mesh, initialized

Spec = Tuple[Optional[str], ...]


def leaf_pspec(x) -> Spec:
    """Shape-based spec for a parameter-like leaf: [D,4,H] / [H,4,H] LSTM
    weights shard H (last axis); a [4,H] gate bias shards H; the [2H,V]
    output weight shards 2H (its input); vectors and scalars replicate."""
    ndim = getattr(x, "ndim", 0)
    shape = getattr(x, "shape", ())
    if ndim == 3:
        return (None, None, "model")
    if ndim == 2:
        if shape[0] == 4:
            return (None, "model")
        return ("model", None)
    return ()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_pspecs(tree) -> Any:
    return _tree_map(leaf_pspec, tree)


def batch_pspec() -> Dict[str, Spec]:
    return {
        "feats": ("data", None, None),
        "feat_lengths": ("data",),
        "labels": ("data", None),
        "label_lengths": ("data",),
    }


def put(x, device) -> torch.Tensor:
    """x (a tensor or a host array, copied) as a tensor on `device`."""
    if torch.is_tensor(x):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def local_rows(n: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of n: the r-th of `mesh.data` equal
    blocks.  n must divide evenly, as jax.device_put requires."""
    if n % mesh.data:
        raise ValueError(
            f"a batch of {n} rows does not split over a data axis of "
            f"{mesh.data}"
        )
    step = n // mesh.data
    return mesh.rank * step, (mesh.rank + 1) * step


def shard_batch(batch, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch, on its device (keys outside
    batch_pspec are dropped)."""
    out = {}
    for k, v in batch.items():
        if k in batch_pspec():
            lo, hi = local_rows(len(v), mesh)
            out[k] = put(v[lo:hi], mesh.device)
    return out


def _replicate(x, mesh: Mesh):
    if not torch.is_tensor(x):
        return x
    x = x.to(mesh.device, copy=True)
    if initialized():
        src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
        dist.broadcast(x, src, group=mesh.group)
    return x


def shard_params(params, mesh: Mesh):
    """A parameter(-shaped) tree on the rank's device, replicated over
    `data`: rank 0's values on every rank (a broadcast a leaf), so ranks
    that drew their parameters from different seeds still agree."""
    return _tree_map(lambda x: _replicate(x, mesh), params)


def shard_state(state, mesh: Mesh):
    """A TrainState (parameters, optimizer accumulators, step) replicated
    over `data` as shard_params does; host values (the learning rate,
    the step count) stay as they are."""
    return state._replace(
        params=shard_params(state.params, mesh),
        opt_state=state.opt_state._replace(
            inner=shard_params(state.opt_state.inner, mesh)),
    )


# the JAX package's aliases
param_sharding_rules = leaf_pspec
param_pspecs = tree_pspecs
