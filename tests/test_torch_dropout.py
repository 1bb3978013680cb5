"""Dropout and twiddle training in the port (eesen_tpu_torch/models/bilstm.py)
against the JAX package on the CPU: the recurrent-dropout scan in both
modes with per-step and per-sequence masks, the mask draws, the model
with dropout from the same masks, and a toy `Trainer.fit` with the
LibriSpeech recipe's dropout settings."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.models import bilstm as jbilstm
from eesen_tpu.models import model as jmodel
from eesen_tpu_torch.models import bilstm as tbilstm
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.training import optim as toptim
from eesen_tpu_torch.training import trainer as ttrainer
from eesen_tpu_torch.training.schedule import NewbobConfig

# f32 end to end: the same arithmetic, float32 sums in another order
RTOL, ATOL = 1e-4, 1e-6
# the LibriSpeech char recipe's dropout (eesen_tpu/recipes/config.py:
# 157-163): no-mem-loss recurrent and forward dropout per sequence, twiddle
LIBRI_DROPOUT = dict(forward_dropout=0.2, recurrent_dropout=0.2,
                     forward_step_dropout=False,
                     recurrent_step_dropout=False,
                     recurrent_dropout_mode="no_mem_loss", twiddle=True)


def np_mask(rng, rate, shape):
    keep = 1.0 - rate
    return ((rng.random(shape) < keep) / keep).astype(np.float32)


def scan_setup(seed, t=9, b=3, d=5, h=6):
    cfg = jbilstm.BiLstmConfig(input_dim=d, cell_dim=h,
                               compute_dtype=jnp.float32)
    p = jbilstm.init_bilstm_layer(jax.random.PRNGKey(seed), cfg)["fw"]
    p = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, b, d)).astype(np.float32)
    lens = np.array([t, t - 4, 0][:b])
    mask = (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)
    return cfg, p, x, mask, rng


@pytest.mark.parametrize("mode", ["no_mem_loss", "rnndrop"])
@pytest.mark.parametrize("per_step", [True, False])
def test_dropout_scan_matches_jax(mode, per_step):
    """`_direction_scan` with a recurrent-dropout mask [T or 1, B, H]
    against the JAX package's, at f32: m and the gradients of x and every
    parameter (rtol 1e-4 / atol 1e-6)."""
    cfg, p, x, mask, rng = scan_setup(3 if per_step else 4)
    cfg = dataclasses.replace(cfg, recurrent_dropout_mode=mode)
    rd = np_mask(rng, 0.3, (x.shape[0] if per_step else 1, 3, 6))
    gm = rng.standard_normal((9, 3, 6)).astype(np.float32)

    def loss_j(pp, xx):
        ms = jbilstm._direction_scan(pp, xx, jnp.asarray(mask), cfg,
                                     jnp.asarray(rd))
        return jnp.sum(ms * gm), ms

    (_, m_j), (g_j, gx_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))

    tcfg = tbilstm.BiLstmConfig(input_dim=5, cell_dim=6,
                                compute_dtype=torch.float32,
                                recurrent_dropout_mode=mode)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in
          p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    m_t = tbilstm._direction_scan(tp, xt, torch.from_numpy(mask), tcfg,
                                  torch.from_numpy(rd))
    grads = torch.autograd.grad((m_t * torch.from_numpy(gm)).sum(),
                                [xt, *tp.values()])
    np.testing.assert_allclose(m_t.detach().numpy(), np.asarray(m_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j),
                               rtol=RTOL, atol=ATOL)
    for k, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_dropout_scan_with_ones_mask_is_the_plain_layer():
    """A mask of ones (the undropped twiddle direction) gives the same m
    as the route without a mask."""
    cfg, p, x, mask, _ = scan_setup(5)
    tcfg = tbilstm.BiLstmConfig(input_dim=5, cell_dim=6,
                                compute_dtype=torch.float32)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    got = tbilstm._direction_scan(tp, xt, mt, tcfg, torch.ones((1, 3, 6)))
    want = tbilstm._direction_scan(tp, xt, mt, tcfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_dropout_scan_with_no_steps():
    cfg = tbilstm.BiLstmConfig(input_dim=3, cell_dim=4)
    p = tbilstm.init_bilstm_layer(torch.Generator().manual_seed(0), cfg,
                                  "cpu")["fw"]
    m = tbilstm._direction_scan(p, torch.zeros((0, 2, 3)),
                                torch.zeros((0, 2)), cfg,
                                torch.ones((1, 2, 4)))
    assert m.shape == (0, 2, 4)


@pytest.mark.parametrize("per_step", [True, False])
def test_dropout_mask_properties(per_step):
    gen = torch.Generator().manual_seed(0)
    m = tbilstm._dropout_mask(gen, 0.2, per_step, 64, 50, 64, "cpu")
    assert m.shape == ((50, 64, 64) if per_step else (1, 64, 64))
    assert m.dtype == torch.float32
    assert set(torch.unique(m).tolist()) == {0.0, 1.25}
    # 1/keep scaling: mean 1 (std of the mean ~1e-3 per step, ~6e-3 per
    # sequence)
    assert abs(float(m.mean()) - 1.0) < 0.03
    again = tbilstm._dropout_mask(torch.Generator().manual_seed(0), 0.2,
                                  per_step, 64, 50, 64, "cpu")
    assert torch.equal(m, again)


def record_masks(monkeypatch):
    """Record the rec_drop_mask each _direction_scan call receives."""
    seen = []
    real = tbilstm._direction_scan

    def spy(p, x, mask, cfg, rec_drop_mask=None):
        seen.append(rec_drop_mask)
        return real(p, x, mask, cfg, rec_drop_mask)

    monkeypatch.setattr(tbilstm, "_direction_scan", spy)
    return seen


def layer_args(seed=0, t=7, b=4, d=5, h=16, **opts):
    cfg = tbilstm.BiLstmConfig(input_dim=d, cell_dim=h,
                               compute_dtype=torch.float32, **opts)
    params = tbilstm.init_bilstm_layer(torch.Generator().manual_seed(seed),
                                       cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (t, b, d)).astype(np.float32))
    return params, x, torch.tensor([t, t - 2, 3, 0]), cfg


def test_twiddle_masks_exactly_one_direction(monkeypatch):
    """Under twiddle both directions take the dropout scan; per layer one
    of them gets a real mask and the other a mask of ones, and over many
    draws each direction is picked."""
    seen = record_masks(monkeypatch)
    params, x, lens, cfg = layer_args(recurrent_dropout=0.5, twiddle=True)
    picked = set()
    for seed in range(12):
        seen.clear()
        tbilstm.bilstm_layer_tm(params, x, lens, cfg, train=True,
                                rng=torch.Generator().manual_seed(seed))
        assert len(seen) == 2 and all(m is not None for m in seen)
        ones = [bool(torch.all(m == 1.0)) for m in seen]
        assert sorted(ones) == [False, True]
        picked.add(ones.index(False))
    assert picked == {0, 1}


def test_forward_dropout_alone_keeps_the_kernel_route(monkeypatch):
    seen = record_masks(monkeypatch)
    params, x, lens, cfg = layer_args(forward_dropout=0.5)
    y = tbilstm.bilstm_layer_tm(params, x, lens, cfg, train=True,
                                rng=torch.Generator().manual_seed(0))
    assert seen == [None, None]
    plain = tbilstm.bilstm_layer_tm(params, x, lens, cfg)
    dropped = (y == 0) & (plain != 0)
    assert bool(dropped.any())
    torch.testing.assert_close(y[~dropped], 2.0 * plain[~dropped])


SMALL = dict(input_dim=6, cell_dim=8, num_layers=2, num_targets=5)


def feats_and_lengths(seed=0, b=3, t=9):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, 6)).astype(np.float32)
    return feats, np.array([t, t - 3, 0][:b], np.int32)


def fake_masks(seed):
    """A stand-in for both packages' _dropout_mask: the i-th call returns
    the i-th mask of a numpy stream, so that both models see the same
    masks in the same order."""
    rng = np.random.default_rng(seed)

    def make(rate, per_step, b, t, d):
        return np_mask(rng, rate, (t, b, d) if per_step else (1, b, d))

    return make


@pytest.mark.parametrize("opts", [
    dict(forward_dropout=0.2, recurrent_dropout=0.3,
         recurrent_dropout_mode="no_mem_loss"),
    dict(forward_dropout=0.3, forward_step_dropout=True,
         recurrent_dropout=0.2, recurrent_step_dropout=True,
         recurrent_dropout_mode="rnndrop"),
])
def test_apply_model_with_dropout_matches_jax(monkeypatch, opts):
    """The whole model with forward and recurrent dropout, fed the same
    masks in the same order (recurrent fw, recurrent bw, forward, per
    layer), at f32: logits and the gradients of every parameter."""
    jm = fake_masks(7)
    tm = fake_masks(7)
    monkeypatch.setattr(jbilstm, "_dropout_mask",
                        lambda k, r, s, b, t, d: jnp.asarray(jm(r, s, b, t, d)))
    monkeypatch.setattr(
        tbilstm, "_dropout_mask",
        lambda g, r, s, b, t, d, dev: torch.from_numpy(tm(r, s, b, t, d)))
    jcfg = jmodel.AcousticModelConfig(**SMALL, compute_dtype=jnp.float32,
                                      **opts)
    tcfg = tmodel.AcousticModelConfig(**SMALL, compute_dtype=torch.float32,
                                      **opts)
    jp = jmodel.init_model(jax.random.PRNGKey(3), jcfg)
    feats, lens = feats_and_lengths()
    w = np.random.default_rng(1).standard_normal((3, 9, 5)).astype(
        np.float32)

    def loss_j(pp):
        lo = jmodel.apply_model(pp, jnp.asarray(feats), jnp.asarray(lens),
                                jcfg, train=True,
                                rng=jax.random.PRNGKey(0))
        return jnp.sum(lo * w), lo

    (_, lo_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(jp)
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    leaves = [p.requires_grad_() for p in toptim.tree_leaves(tp)]
    lo_t = tmodel.apply_model(toptim.tree_unflatten(tp, leaves),
                              torch.from_numpy(feats),
                              torch.from_numpy(lens), tcfg, train=True,
                              rng=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad((lo_t * torch.from_numpy(w)).sum(), leaves)
    np.testing.assert_allclose(lo_t.detach().numpy(), np.asarray(lo_j),
                               rtol=RTOL, atol=1e-5)
    for a, g in zip(grads, jax.tree_util.tree_leaves(g_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=1e-5)


def test_apply_model_train_is_reproducible_for_a_seed():
    cfg = tmodel.AcousticModelConfig(**SMALL, compute_dtype=torch.float32,
                                     **LIBRI_DROPOUT)
    p = tmodel.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    feats, lens = feats_and_lengths(2)
    args = (torch.from_numpy(feats), torch.from_numpy(lens), cfg)
    run = lambda seed: tmodel.apply_model(
        p, *args, train=True, rng=torch.Generator().manual_seed(seed))
    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    # evaluation ignores dropout; training with dropout needs an rng
    assert torch.equal(tmodel.apply_model(p, *args),
                       tmodel.apply_model(p, *args, rng=torch.Generator()))
    with pytest.raises(ValueError, match="rng"):
        tmodel.apply_model(p, *args, train=True)


def toy_batches(n=3, b=4, t=12):
    out = []
    for s in range(n):
        rng = np.random.default_rng(s)
        feats = (0.3 * rng.standard_normal((b, t, 6))).astype(np.float32)
        feat_lengths = np.array([t, t - 3, 7, 0][:b], np.int32)
        label_lengths = np.array([3, 2, 1, 0][:b], np.int32)
        labels = np.zeros((b, 3), np.int32)
        for i in range(b):
            labels[i, :label_lengths[i]] = rng.integers(1, 5,
                                                        label_lengths[i])
            feats[i, feat_lengths[i]:] = 0.0
        out.append({"feats": feats, "feat_lengths": feat_lengths,
                    "labels": labels, "label_lengths": label_lengths})
    return out


def test_trainer_fit_with_librispeech_dropout():
    """A CPU `Trainer.fit` of a toy model with the LibriSpeech recipe's
    dropout settings (no-mem-loss recurrent and forward dropout per
    sequence, twiddle), SGD as the recipe: finite losses, a moving
    model, and the same history again from the same seed."""
    cfg = ttrainer.TrainerConfig(
        model=tmodel.AcousticModelConfig(
            **SMALL, compute_dtype=torch.float32, **LIBRI_DROPOUT),
        optimizer=toptim.OptimizerConfig(algorithm="sgd", momentum=0.9,
                                         max_grad=50.0),
        newbob=NewbobConfig(learn_rate=0.05, max_iters=2, min_iters=2),
        report_step=1000)

    def fit():
        tr = ttrainer.Trainer(cfg, device="cpu")
        before = [p.clone() for p in toptim.tree_leaves(tr.state.params)]
        hist = tr.fit(lambda: iter(toy_batches()), lambda: iter(toy_batches()))
        moved = any(not torch.equal(a, b) for a, b in zip(
            before, toptim.tree_leaves(tr.state.params)))
        return hist, moved

    hist, moved = fit()
    assert sorted(hist) == [1, 2] and moved
    assert all(np.isfinite(h["train_obj"]) and np.isfinite(h["cv_obj"])
               for h in hist.values())
    assert fit()[0] == hist
