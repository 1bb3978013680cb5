"""Optimizers with the reference's update semantics (counterpart of
eesen_tpu/training/optim.py).

The reference's three update rules (src/net/trainable-layer.h:260-336),
with elementwise gradient clipping to +-max_grad first (src/net/
bilstm-layer.h:846-865), as the JAX package builds them from optax, over
ONE concatenated parameter vector (its `flat=True` path):

  clip      g = clamp(g, -max_grad, max_grad)          (when max_grad > 0)
  decay     g = g + weight_decay * p                    (optax.add_decayed_weights)
  sgd       trace = g + momentum * trace; u = trace     (optax.trace, no Nesterov;
                                                          u = g when momentum is 0)
  adagrad   sos = g*g + sos; u = rsqrt(sos + eps) * g where sos > 0, else 0
                                                        (optax.scale_by_rss, initial 0)
  rmsprop   nu = (1-rho) * g*g + rho * nu; u = rsqrt(nu + eps) * g
                                                        (optax.scale_by_rms, eps inside)
  adamw     mu = b1 * mu + (1-b1) * g; nu = b2 * nu + (1-b2) * g*g; count += 1;
            u = (mu / (1-b1^count)) / (sqrt(nu / (1-b2^count)) + eps)
                + weight_decay * p                      (optax.adamw: the decay
                                                          decoupled, not in g)
  update    p = p + (-learning_rate) * u

The learning rate is a per-step hyperparameter in the state
(`hyperparams["learning_rate"]`), which the trainer replaces every step
with the epoch's newbob rate.  Vectors are laid out as
`jax.flatten_util.ravel_pytree` lays out the JAX parameters (dict keys
sorted, lists in order, each leaf row-major), so `opt_state_from_jax`
carries a JAX optimizer state across as it is.

AdamW is the Conformer's optimizer (NeMo's recipe) and has no
counterpart in the JAX package; it matches `torch.optim.AdamW`.

Unlike the JAX package's flat path, which calls its chain without the
parameters and so raises for weight_decay > 0, weight decay works here,
as in the JAX package's `flat=False` path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from eesen_tpu_torch.models.model import check_device


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    algorithm: str = "sgd"          # sgd | adagrad | rmsprop | adamw
    momentum: float = 0.9           # (train-opts.h: momentum, default 0.0 in
                                    # C++ but recipes pass 0.9)
    max_grad: float = 50.0          # elementwise clip (bilstm-layer <MaxGrad>)
    adagrad_epsilon: float = 1e-10  # (train-opts.h adagrad_epsilon)
    rmsprop_rho: float = 0.9        # (train-opts.h rmsprop_rho)
    weight_decay: float = 0.0       # l2 penalty (train-opts.h l2_penalty);
                                    # adamw: the decoupled decay


# the accumulator each algorithm keeps, under optax's name for it
_ACCUMULATOR = {"sgd": "trace", "adagrad": "sum_of_squares", "rmsprop": "nu"}
_ADAM = ("mu", "nu")        # adamw's moments; its step count is "count"
# adamw's moment decays and epsilon: NeMo's Conformer recipe
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.98, 1e-8


class OptState(NamedTuple):
    """`hyperparams` holds the per-step learning rate; `inner` the
    accumulator over the flat parameter vector (empty for plain SGD;
    adamw's two moments and its step count)."""
    hyperparams: Dict[str, float]
    inner: Dict[str, torch.Tensor]


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in JAX's pytree order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves: List[Any]):
    """`tree`'s structure with `leaves` (in tree_leaves order) in place of
    its own."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree)


def ravel(tree) -> torch.Tensor:
    """All leaves, row-major, concatenated in tree_leaves order."""
    return torch.cat([x.reshape(-1) for x in tree_leaves(tree)])


def unravel(tree, flat: torch.Tensor):
    """The inverse of `ravel` for a tree shaped like `tree`."""
    leaves, offset = [], 0
    for x in tree_leaves(tree):
        leaves.append(flat[offset:offset + x.numel()].view_as(x))
        offset += x.numel()
    return tree_unflatten(tree, leaves)


def clip_by_value(g: torch.Tensor, max_grad: float) -> torch.Tensor:
    """Elementwise gradient clamp to [-max_grad, +max_grad]."""
    return torch.clamp(g, -max_grad, max_grad)


class Optimizer:
    """`init(params)` -> OptState; `update(grads, state, params)` ->
    (updates, state) with updates shaped like the parameters, to be added
    by `apply_updates` (the optax protocol, over one flat vector)."""

    def __init__(self, cfg: OptimizerConfig):
        if cfg.algorithm not in (*_ACCUMULATOR, "adamw"):
            raise ValueError(f"unknown update algorithm: {cfg.algorithm}")
        self.cfg = cfg

    def init(self, params) -> OptState:
        flat = ravel(params)
        inner = {}
        if self.cfg.algorithm == "adamw":
            inner = {k: torch.zeros_like(flat) for k in _ADAM}
            inner["count"] = torch.zeros((), dtype=torch.int64,
                                         device=flat.device)
        elif self.cfg.algorithm != "sgd" or self.cfg.momentum > 0:
            inner[_ACCUMULATOR[self.cfg.algorithm]] = torch.zeros_like(flat)
        return OptState({"learning_rate": 0.0}, inner)

    def update(self, grads, state: OptState, params) -> Tuple[Any, OptState]:
        cfg = self.cfg
        g = ravel(grads)
        if cfg.max_grad > 0:
            g = clip_by_value(g, cfg.max_grad)
        if cfg.weight_decay > 0 and cfg.algorithm != "adamw":
            g = g + cfg.weight_decay * ravel(params)
        inner = dict(state.inner)
        if cfg.algorithm == "sgd":
            if cfg.momentum > 0:
                g = g + cfg.momentum * inner["trace"]
                inner["trace"] = g
        elif cfg.algorithm == "adagrad":
            sos = g * g + inner["sum_of_squares"]
            inner["sum_of_squares"] = sos
            g = torch.where(sos > 0, torch.rsqrt(sos + cfg.adagrad_epsilon),
                            0.0) * g
        elif cfg.algorithm == "rmsprop":
            nu = (1 - cfg.rmsprop_rho) * g.pow(2) + cfg.rmsprop_rho * inner["nu"]
            inner["nu"] = nu
            g = torch.rsqrt(nu + cfg.adagrad_epsilon) * g
        else:
            b1, b2 = ADAM_B1, ADAM_B2
            mu = torch.lerp(inner["mu"], g, 1 - b1)
            nu = torch.lerp(inner["nu"], g * g, 1 - b2)
            count = inner["count"] + 1
            inner.update(mu=mu, nu=nu, count=count)
            n = count.to(g.dtype)
            g = (mu / (1 - b1 ** n)) / (
                torch.sqrt(nu / (1 - b2 ** n)) + ADAM_EPS)
            if cfg.weight_decay > 0:
                g = g + cfg.weight_decay * ravel(params)
        u = -torch.as_tensor(state.hyperparams["learning_rate"],
                             dtype=g.dtype, device=g.device) * g
        return unravel(grads, u), OptState(state.hyperparams, inner)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return Optimizer(cfg)


def apply_updates(params, updates):
    """p + u, leaf by leaf (optax.apply_updates)."""
    return tree_unflatten(params, [
        p + u for p, u in zip(tree_leaves(params), tree_leaves(updates))
    ])


def opt_state_from_jax(jax_state, device="cuda") -> OptState:
    """The JAX package's FlatOptState (from `make_optimizer(flat=True)`,
    leaves as arrays) as an OptState on `device`: the learning rate and
    the accumulator vector (optax's TraceState.trace,
    ScaleByRssState.sum_of_squares or ScaleByRmsState.nu), found by field
    name in the chain's states."""
    device = check_device(device)
    inner = {}
    for st in jax_state.inner:          # optax.chain's tuple of states
        for name in _ACCUMULATOR.values():
            if name in getattr(st, "_fields", ()):
                inner[name] = torch.from_numpy(
                    np.array(getattr(st, name), dtype=np.float32, copy=True)
                ).to(device)
    lr = float(np.asarray(jax_state.hyperparams["learning_rate"]))
    return OptState({"learning_rate": lr}, inner)
