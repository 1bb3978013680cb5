"""The port's acoustic model and priors (eesen_tpu_torch/models) against
the JAX package on the CPU, from the same parameters (params_from_jax)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.models import model as jmodel
from eesen_tpu.models import priors as jpriors
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.models import priors as tpriors

SMALL = dict(input_dim=24, cell_dim=32, num_layers=2, num_targets=12)


def configs(bidirectional, bf16):
    jcfg = jmodel.AcousticModelConfig(
        **SMALL, bidirectional=bidirectional,
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32,
    )
    tcfg = tmodel.AcousticModelConfig(
        **SMALL, bidirectional=bidirectional,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32,
    )
    return jcfg, tcfg


def inputs(seed=0, b=3, t=9):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, SMALL["input_dim"])).astype(np.float32)
    lens = np.array([t, t - 3, t // 2], np.int32)
    return feats, lens


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_apply_model_matches_jax(bidirectional, bf16):
    """f32: atol 1e-4 (sums in another order).  bf16: both cast the
    same operands to bf16, but a last-bit difference in a layer output
    can flip its bf16 rounding (2^-9 relative), so atol 2e-2."""
    jcfg, tcfg = configs(bidirectional, bf16)
    jp = jmodel.init_model(jax.random.PRNGKey(1), jcfg)
    jp_np = jax.tree_util.tree_map(np.asarray, jp)
    feats, lens = inputs()
    want = np.asarray(jmodel.apply_model(
        jp, jnp.asarray(feats), jnp.asarray(lens), jcfg
    ))
    tp = tmodel.params_from_jax(jp_np, device="cpu")
    got = tmodel.apply_model(
        tp, torch.from_numpy(feats), torch.from_numpy(lens), tcfg
    )
    assert got.shape == want.shape and got.dtype == torch.float32
    atol = 2e-2 if bf16 else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_params_from_jax_name_for_name():
    jcfg, tcfg = configs(True, False)
    jp = jax.tree_util.tree_map(
        np.asarray, jmodel.init_model(jax.random.PRNGKey(2), jcfg)
    )
    tp = tmodel.params_from_jax(jp, device="cpu")
    assert tp.keys() == jp.keys()
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for d in ("fw", "bw"):
            assert tl[d].keys() == jl[d].keys()
            for k in jl[d]:
                np.testing.assert_array_equal(tl[d][k].numpy(), jl[d][k])
    assert tmodel.model_num_params(tp) == jmodel.model_num_params(jp)


def test_init_model_shapes_and_range():
    _, tcfg = configs(True, False)
    gen = torch.Generator().manual_seed(0)
    p = tmodel.init_model(gen, tcfg, device="cpu")
    jcfg, _ = configs(True, False)
    jp = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    shapes = lambda tree, f: [f(x) for x in jax.tree_util.tree_leaves(tree)]
    assert shapes(p, lambda x: tuple(x.shape)) == \
        shapes(jp, lambda x: tuple(x.shape))
    for x in jax.tree_util.tree_leaves(p):
        assert float(x.abs().max()) <= tcfg.param_range
    # a seeded generator gives the same parameters again
    p2 = tmodel.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert torch.equal(p["out"]["w"], p2["out"]["w"])


def test_fgate_bias_offsets_the_forget_gate():
    _, tcfg = configs(True, False)
    tcfg = dataclasses.replace(tcfg, fgate_bias=5.0, num_layers=1)
    p = tmodel.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    bias = p["layers"][0]["fw"]["bias"]
    assert float(bias[2].min()) >= 5.0 - tcfg.param_range
    assert float(bias[[0, 1, 3]].abs().max()) <= tcfg.param_range


def test_train_mode_is_not_ported():
    """train=True without dropout runs the stack as inference does (the
    same logits); twiddle without recurrent dropout changes nothing, as
    in the JAX package.  Dropout is ported now: with it, train=True needs
    an rng and changes the logits (tests/test_torch_dropout.py)."""
    _, tcfg = configs(True, False)
    p = tmodel.init_model(torch.Generator().manual_seed(0), tcfg, "cpu")
    feats, lens = inputs()
    args = (torch.from_numpy(feats), torch.from_numpy(lens))
    plain = tmodel.apply_model(p, *args, tcfg)
    assert torch.equal(tmodel.apply_model(p, *args, tcfg, train=True), plain)
    assert torch.equal(tmodel.apply_model(
        p, *args, dataclasses.replace(tcfg, twiddle=True), train=True,
        rng=torch.Generator().manual_seed(0)), plain)
    for opt in (dict(forward_dropout=0.2), dict(recurrent_dropout=0.2)):
        cfg = dataclasses.replace(tcfg, **opt)
        with pytest.raises(ValueError, match="rng"):
            tmodel.apply_model(p, *args, cfg, train=True)
        got = tmodel.apply_model(p, *args, cfg, train=True,
                                 rng=torch.Generator().manual_seed(0))
        assert not torch.equal(got, plain)


@pytest.mark.parametrize("opts", [
    jpriors.ClassPriorOptions(),
    jpriors.ClassPriorOptions(prior_cutoff=3.0, blank_scale=0.5),
])
def test_priors_match_jax(opts):
    rng = np.random.default_rng(0)
    labels = [rng.integers(1, 12, rng.integers(1, 8)) for _ in range(20)]
    counts_j = jpriors.counts_from_labels(labels, 14)
    counts_t = tpriors.counts_from_labels(labels, 14)
    np.testing.assert_array_equal(counts_t, counts_j)
    topts = tpriors.ClassPriorOptions(**dataclasses.asdict(opts))
    lp_j = jpriors.compute_log_priors(counts_j, opts)
    lp_t = tpriors.compute_log_priors(counts_t, topts)
    np.testing.assert_array_equal(lp_t, lp_j)
    post = rng.standard_normal((2, 5, 14)).astype(np.float32)
    for scale in (1.0, 0.7):
        want = np.asarray(jpriors.subtract_priors(jnp.asarray(post), lp_j,
                                                  scale))
        got = tpriors.subtract_priors(torch.from_numpy(post), lp_t, scale)
        np.testing.assert_array_equal(got.numpy(), want)
