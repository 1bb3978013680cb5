"""Sharding rules for parameters, optimizer state and batches
(counterpart of eesen_tpu/parallel/sharding.py).

A partition spec is plain data here: a tuple of mesh axis names (or None)
per dimension, so `(None, None, "model")` is `tuple(P(None, None,
"model"))` of the JAX package.

- Parameters and optimizer state take rank 0's values (a broadcast over
  the whole mesh), replicated over `data`; over `model` each leaf is held
  as block `model_index` of the dimension its spec names, a contiguous
  block as `jax.device_put` places it (`addressable_shards`).  The flat
  optimizer vector is 1-D, so its spec is `()` and it is replicated, as
  in the JAX package.  `gather_params` puts the whole tree back together
  on every rank of a model group (reading a sharded `jax.Array` whole).
- A batch splits its leading axis over `data`, each rank taking the block
  of its data index, as `jax.device_put` places a `P("data")` array.
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


def local_rows(n: int, mesh: Mesh, axis: str = "data") -> Tuple[int, int]:
    """This rank's rows [lo, hi) of n: block i of `size` equal blocks,
    with (size, i) the axis's size and this rank's index on it.  n must
    divide evenly, as jax.device_put requires."""
    size, index = mesh.axis(axis)
    if n % size:
        raise ValueError(
            f"a batch of {n} rows does not split over a {axis} axis of "
            f"{size}"
        )
    step = n // size
    return index * step, (index + 1) * step


def shard_batch(batch, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (the block of its data index),
    on its device (keys outside batch_pspec are dropped)."""
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


def _model_dim(x) -> Optional[int]:
    """The dimension of a leaf that its spec splits over `model` (None:
    replicated)."""
    spec = leaf_pspec(x) if torch.is_tensor(x) else ()
    return spec.index("model") if "model" in spec else None


def _split_dim(x, mesh: Mesh) -> Optional[int]:
    """The dimension of x that the mesh's `model` axis splits (None: x is
    whole on every rank).  A split that does not divide evenly raises, as
    jax.device_put does."""
    dim = _model_dim(x)
    if mesh.model == 1 or dim is None:
        return None
    if x.shape[dim] % mesh.model:
        raise ValueError(
            f"a leaf of shape {tuple(x.shape)} does not split its dimension "
            f"{dim} over a model axis of {mesh.model}"
        )
    return dim


def local_shards(tree, mesh: Mesh):
    """The rank's blocks of a whole parameter(-shaped) tree: each leaf that
    `model` splits becomes block `model_index` of its split dimension
    (contiguous), every other leaf stays as it is.  No communication."""
    def block(x):
        dim = _split_dim(x, mesh)
        if dim is None:
            return x
        step = x.shape[dim] // mesh.model
        return x.narrow(dim, mesh.model_index * step, step).contiguous()

    return _tree_map(block, tree)


def shard_params(params, mesh: Mesh):
    """A parameter(-shaped) tree on the rank's device: rank 0's values on
    every rank (a broadcast a leaf, so ranks that drew their parameters
    from different seeds still agree), held as the rank's blocks over
    `model` (`local_shards`) and replicated over `data`."""
    return local_shards(_tree_map(lambda x: _replicate(x, mesh), params),
                        mesh)


def shard_state(state, mesh: Mesh):
    """A TrainState (parameters, optimizer accumulators, step) placed as
    shard_params places a tree: the flat accumulators are 1-D, so they are
    replicated; host values (the learning rate, the step count) stay as
    they are."""
    return state._replace(
        params=shard_params(state.params, mesh),
        opt_state=state.opt_state._replace(
            inner=shard_params(state.opt_state.inner, mesh)),
    )


def gather_params(params, mesh: Mesh):
    """The whole tree of the rank's blocks, on every rank: the leaves that
    `model` splits travel in one flat bucket, all-gathered over the rank's
    model group, and are put back together along their split dimension;
    replicated leaves are the rank's own.  Every rank of the model group
    calls it.  On a mesh without a model axis the tree comes back as it
    is."""
    if mesh.model == 1:
        return params
    split = []
    _tree_map(lambda x: _model_dim(x) is not None and split.append(x),
              params)
    if not split:
        return params
    runs, group = mesh.axis_group("model")
    if not runs:
        raise RuntimeError(
            f"gathering over a model axis of {mesh.model} needs the mesh's "
            f"process group"
        )
    bucket = torch.cat([x.reshape(-1) for x in split])
    parts = [torch.empty_like(bucket) for _ in range(mesh.model)]
    dist.all_gather(parts, bucket, group=group)
    offset = 0

    def whole(x):
        nonlocal offset
        dim = _model_dim(x)
        if dim is None:
            return x
        lo, offset = offset, offset + x.numel()
        return torch.cat([p[lo:offset].view_as(x) for p in parts], dim)

    return _tree_map(whole, params)


# the JAX package's aliases
param_sharding_rules = leaf_pspec
param_pspecs = tree_pspecs
