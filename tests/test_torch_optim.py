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


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_adamw_matches_torch_optim_adamw(weight_decay):
    """Five steps of `Optimizer(adamw)` over the flat vector against
    `torch.optim.AdamW` leaf by leaf with the same betas, epsilon and
    decoupled weight decay: the same formula in another order of
    operations, so float32 round-off apart (atol 1e-6 on values of ~0.1
    moved by ~5 * lr)."""
    params = tmodel.params_from_jax(jax_params(), device="cpu")
    lr, b1, b2, eps = 1e-2, toptim.ADAM_B1, toptim.ADAM_B2, toptim.ADAM_EPS
    assert (b1, b2, eps) == (0.9, 0.98, 1e-8)       # NeMo's Conformer recipe
    tx = toptim.make_optimizer(toptim.OptimizerConfig(
        algorithm="adamw", max_grad=0.0, weight_decay=weight_decay))
    st = tx.init(params)
    st = st._replace(hyperparams={"learning_rate": lr})
    assert set(st.inner) == {"mu", "nu", "count"}
    ref = [p.clone().requires_grad_() for p in toptim.tree_leaves(params)]
    opt = torch.optim.AdamW(ref, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)
    p = params
    for i in range(5):
        g = tmodel.params_from_jax(grads_like(jax_params(), i), device="cpu")
        upd, st = tx.update(g, st, p)
        p = toptim.apply_updates(p, upd)
        for r, gi in zip(ref, toptim.tree_leaves(g)):
            r.grad = gi.clone()
        opt.step()
    assert int(st.inner["count"]) == 5
    for a, b in zip(toptim.tree_leaves(p), ref):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=0,
                                   atol=1e-6)
    # the first moment is the optimizer's: (1 - b1) g after one step
    st1 = tx.init(params)
    g0 = tmodel.params_from_jax(grads_like(jax_params(), 0), device="cpu")
    _, st1 = tx.update(g0, st1._replace(hyperparams={"learning_rate": lr}),
                       params)
    np.testing.assert_allclose(st1.inner["mu"].numpy(),
                               ((1 - b1) * toptim.ravel(g0)).numpy(),
                               rtol=1e-6, atol=0)


def test_buffers_are_no_leaves():
    """A `buffers` entry (a Conformer's BatchNorm statistics) is kept from
    the optimizer by the trainer (`trained`), which leaves the LSTM's
    tree as the same object; the optimizer's own tree functions treat
    every key alike."""
    from eesen_tpu_torch.training.trainer import trained

    tree = {"w": torch.ones(2), "buffers": [{"mean": torch.zeros(3)}],
            "b": torch.zeros(1)}
    kept = trained(tree)
    assert [t.shape for t in toptim.tree_leaves(kept)] == [(1,), (2,)]
    assert tree["buffers"][0]["mean"].shape == (3,)
    tx = toptim.make_optimizer(toptim.OptimizerConfig(algorithm="adamw"))
    assert tx.init(kept).inner["mu"].shape == (3,)
    assert toptim.ravel(tree).shape == (6,)
    out = toptim.tree_unflatten(kept, [torch.full((1,), 5.0),
                                       torch.full((2,), 7.0)])
    assert set(out) == {"w", "b"}
    assert out["b"].tolist() == [5.0] and out["w"].tolist() == [7.0, 7.0]
    lstm = {"layers": [{"w": torch.ones(2)}], "out": torch.zeros(1)}
    assert trained(lstm) is lstm
