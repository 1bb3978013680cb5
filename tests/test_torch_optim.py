"""The port's optimizers (eesen_tpu_torch/training/optim.py) against the
JAX package's `make_optimizer`: the same gradients fed to both for
several steps, with clipping active."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eesen_tpu.models import model as jmodel
from eesen_tpu.training import optim as joptim
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.training import optim as toptim

CFG = jmodel.AcousticModelConfig(input_dim=6, cell_dim=8, num_layers=2,
                                 num_targets=5, compute_dtype=jnp.float32)


def jax_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jmodel.init_model(jax.random.PRNGKey(seed), CFG))


def grads_like(params, step):
    """The same gradients for both packages, large enough (x3) that
    max_grad=1 clips some of them."""
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 3.0).astype(np.float32),
        params)


def run_jax(params, ocfg, steps, flat=True, state=None, lr=0.1):
    tx = joptim.make_optimizer(ocfg, flat=flat)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(p) if state is None else state
    st = st._replace(hyperparams=dict(st.hyperparams,
                                      learning_rate=jnp.float32(lr)))
    for i in steps:
        g = jax.tree_util.tree_map(jnp.asarray, grads_like(params, i))
        upd, st = tx.update(g, st, p)
        p = optax.apply_updates(p, upd)
    return p, st


def run_torch(params, ocfg, steps, state=None, lr=0.1):
    tx = toptim.make_optimizer(toptim.OptimizerConfig(
        **{f: getattr(ocfg, f) for f in ocfg.__dataclass_fields__}))
    p = tmodel.params_from_jax(params, device="cpu")
    st = tx.init(p) if state is None else state
    st = st._replace(hyperparams=dict(st.hyperparams, learning_rate=lr))
    for i in steps:
        g = tmodel.params_from_jax(grads_like(params, i), device="cpu")
        upd, st = tx.update(g, st, p)
        p = toptim.apply_updates(p, upd)
    return p, st


def assert_same_params(p_t, p_j, atol):
    leaves_j = jax.tree_util.tree_leaves(p_j)
    leaves_t = toptim.tree_leaves(p_t)
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("algo", ["sgd", "adagrad", "rmsprop"])
def test_updates_match_make_optimizer(algo, weight_decay):
    """Five steps from the same parameters and gradients: the same optax
    formulas elementwise, so the parameters agree to float32 rounding
    (atol 1e-6 on values of ~0.1; rsqrt may differ by an ulp).  With
    weight decay the JAX reference is its flat=False chain: its flat path
    raises (test_jax_flat_path_refuses_weight_decay)."""
    ocfg = joptim.OptimizerConfig(algorithm=algo, momentum=0.9,
                                  max_grad=1.0, weight_decay=weight_decay)
    params = jax_params()
    p_j, _ = run_jax(params, ocfg, range(5), flat=weight_decay == 0)
    p_t, _ = run_torch(params, ocfg, range(5))
    assert_same_params(p_t, p_j, atol=1e-6)


def test_sgd_without_momentum_or_clip():
    ocfg = joptim.OptimizerConfig(algorithm="sgd", momentum=0.0,
                                  max_grad=0.0)
    params = jax_params(1)
    p_j, _ = run_jax(params, ocfg, range(3))
    p_t, st = run_torch(params, ocfg, range(3))
    assert st.inner == {}
    assert_same_params(p_t, p_j, atol=1e-6)


def test_jax_flat_path_refuses_weight_decay():
    """The reference behaviour the port departs from (ROADMAP.md §3):
    make_optimizer(flat=True) calls its chain without the parameters, so
    optax.add_decayed_weights raises."""
    ocfg = joptim.OptimizerConfig(weight_decay=1e-3)
    with pytest.raises(ValueError, match="params"):
        run_jax(jax_params(), ocfg, range(1), flat=True)


@pytest.mark.parametrize("algo", ["sgd", "adagrad", "rmsprop"])
def test_opt_state_from_jax_continues_the_run(algo):
    """Two steps in JAX, the state carried across, two more in each
    package: the same parameters as four steps in JAX."""
    ocfg = joptim.OptimizerConfig(algorithm=algo, max_grad=1.0)
    params = jax_params(2)
    p_j2, st_j2 = run_jax(params, ocfg, range(2))
    p_j4, _ = run_jax(params, ocfg, range(4))
    st_t = toptim.opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, st_j2), device="cpu")
    assert set(st_t.inner) == {toptim._ACCUMULATOR[algo]}
    mid = jax.tree_util.tree_map(np.asarray, p_j2)
    p_t, _ = run_torch(mid, ocfg, range(2, 4), state=st_t)
    assert_same_params(p_t, p_j4, atol=1e-6)


def test_ravel_matches_jax_layout():
    """ravel lays the parameters out as jax.flatten_util.ravel_pytree."""
    from jax.flatten_util import ravel_pytree

    params = jax_params(3)
    want, _ = ravel_pytree(params)
    got = toptim.ravel(tmodel.params_from_jax(params, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = toptim.unravel(tmodel.params_from_jax(params, device="cpu"), got)
    assert_same_params(back, params, atol=0)


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown update algorithm"):
        toptim.make_optimizer(toptim.OptimizerConfig(algorithm="adam"))
