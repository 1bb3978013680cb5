"""The port's batch-major BiLSTM layer (eesen_tpu_torch/models/bilstm.py
`bilstm_layer`) and `_reverse_by_length` against the JAX package's on the
CPU, from the same parameters (params_from_jax), in float32: outputs at
rtol 1e-4 / atol 1e-6 (the same arithmetic, float32 sums in another
order), the length masking and padding cases of tests/test_bilstm.py,
and training with the same dropout masks in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.models import bilstm as jbilstm
from eesen_tpu_torch.models import bilstm as tbilstm
from eesen_tpu_torch.models.model import params_from_jax

from tests.test_torch_dropout import fake_masks

RTOL, ATOL = 1e-4, 1e-6


def layer(seed, d=5, h=6, bidirectional=True, **opts):
    jcfg = jbilstm.BiLstmConfig(input_dim=d, cell_dim=h,
                                bidirectional=bidirectional,
                                compute_dtype=jnp.float32, **opts)
    tcfg = tbilstm.BiLstmConfig(input_dim=d, cell_dim=h,
                                bidirectional=bidirectional,
                                compute_dtype=torch.float32, **opts)
    jp = jbilstm.init_bilstm_layer(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jcfg, tcfg, jp, tp


def both(jcfg, tcfg, jp, tp, x, lens):
    want = np.asarray(jbilstm.bilstm_layer(jp, jnp.asarray(x),
                                           jnp.asarray(lens), jcfg))
    got = tbilstm.bilstm_layer(tp, torch.from_numpy(x),
                               torch.from_numpy(lens), tcfg)
    return got, want


@pytest.mark.parametrize("bidirectional", [True, False])
def test_bilstm_layer_matches_jax(bidirectional):
    jcfg, tcfg, jp, tp = layer(0, bidirectional=bidirectional)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 9, 5)).astype(np.float32)
    lens = np.array([9, 5, 0], np.int32)
    got, want = both(jcfg, tcfg, jp, tp, x, lens)
    assert got.shape == (3, 9, 12 if bidirectional else 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the time-major layer, transposed, bit for bit
    tm = tbilstm.bilstm_layer_tm(tp, torch.from_numpy(x).transpose(0, 1)
                                 .contiguous(), torch.from_numpy(lens), tcfg)
    torch.testing.assert_close(got, tm.transpose(0, 1), rtol=0, atol=0)


def test_bilstm_layer_length_masking():
    """tests/test_bilstm.py: a padded batch gives the unpadded sequence's
    outputs and zeros past the length, as the JAX layer does."""
    jcfg, tcfg, jp, tp = layer(1, d=3, h=4)
    rng = np.random.default_rng(1)
    x_short = rng.standard_normal((1, 5, 3)).astype(np.float32)
    x_padded = np.concatenate(
        [x_short, rng.standard_normal((1, 4, 3)).astype(np.float32)], axis=1)
    lens = np.array([5], np.int32)
    y_short, _ = both(jcfg, tcfg, jp, tp, x_short, lens)
    y_padded, want = both(jcfg, tcfg, jp, tp, x_padded, lens)
    np.testing.assert_allclose(y_padded.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y_padded[0, :5].numpy(), y_short[0].numpy(),
                               rtol=RTOL, atol=ATOL)
    assert bool((y_padded[0, 5:] == 0.0).all())


def test_bilstm_layer_is_padding_invariant():
    """Whatever the padded frames hold, the valid frames are the same."""
    _, tcfg, _, tp = layer(2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 5)).astype(np.float32)
    lens = torch.tensor([8, 4])
    y = tbilstm.bilstm_layer(tp, torch.from_numpy(x), lens, tcfg)
    x2 = x.copy()
    x2[1, 4:] = rng.standard_normal((4, 5)) * 100.0
    y2 = tbilstm.bilstm_layer(tp, torch.from_numpy(x2), lens, tcfg)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)


@pytest.mark.parametrize("opts", [
    dict(forward_dropout=0.2, recurrent_dropout=0.3,
         recurrent_dropout_mode="no_mem_loss"),
    dict(forward_dropout=0.3, forward_step_dropout=True,
         recurrent_dropout=0.2, recurrent_step_dropout=True,
         recurrent_dropout_mode="rnndrop"),
    dict(),
])
def test_bilstm_layer_train_matches_jax(monkeypatch, opts):
    """train=True fed the same masks in the same order (recurrent fw,
    recurrent bw, forward): outputs and the gradients of x and every
    parameter.  With no dropout, training equals evaluation."""
    jm, tm = fake_masks(5), fake_masks(5)
    monkeypatch.setattr(jbilstm, "_dropout_mask",
                        lambda k, r, s, b, t, d: jnp.asarray(jm(r, s, b, t, d)))
    monkeypatch.setattr(
        tbilstm, "_dropout_mask",
        lambda g, r, s, b, t, d, dev: torch.from_numpy(tm(r, s, b, t, d)))
    jcfg, tcfg, jp, tp = layer(3, **opts)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    lens = np.array([7, 4, 2], np.int32)
    gy = rng.standard_normal((3, 7, 12)).astype(np.float32)

    def loss_j(p, xx):
        y = jbilstm.bilstm_layer(p, xx, jnp.asarray(lens), jcfg, train=True,
                                 rng=jax.random.PRNGKey(0))
        return jnp.sum(y * gy), y

    (_, y_j), (g_j, gx_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    leaves = [(d, k, v.requires_grad_()) for d in tp for k, v in tp[d].items()]
    xt = torch.from_numpy(x).requires_grad_()
    y_t = tbilstm.bilstm_layer(tp, xt, torch.from_numpy(lens), tcfg,
                               train=True, rng=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad((y_t * torch.from_numpy(gy)).sum(),
                                [xt, *(v for _, _, v in leaves)])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j),
                               rtol=RTOL, atol=ATOL)
    for (d, k, _), g in zip(leaves, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[d][k]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{d}.{k}")
    if not opts:
        y_eval = tbilstm.bilstm_layer(tp, xt, torch.from_numpy(lens), tcfg)
        torch.testing.assert_close(y_t, y_eval, rtol=0, atol=0)


def test_dropout_needs_a_generator():
    _, tcfg, _, tp = layer(4, forward_dropout=0.5)
    with pytest.raises(ValueError):
        tbilstm.bilstm_layer(tp, torch.zeros((1, 3, 5)), torch.tensor([3]),
                             tcfg, train=True)


@pytest.mark.parametrize("case", ["test_bilstm", "random"])
def test_reverse_by_length_matches_jax(case):
    if case == "test_bilstm":
        x = np.arange(12, dtype=np.float32).reshape(1, 6, 2)
        lens = np.array([4], np.int32)
    else:
        rng = np.random.default_rng(9)
        x = rng.standard_normal((4, 7, 3)).astype(np.float32)
        lens = np.array([7, 3, 0, 1], np.int32)
    want = np.asarray(jbilstm._reverse_by_length(jnp.asarray(x),
                                                 jnp.asarray(lens)))
    got = tbilstm._reverse_by_length(torch.from_numpy(x),
                                     torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "test_bilstm":
        np.testing.assert_array_equal(got[0, :4, 0].numpy(), [6, 4, 2, 0])
        np.testing.assert_array_equal(got[0, 4:, 0].numpy(), [8, 10])
