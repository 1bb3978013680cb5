"""The port's LSTM backward (eesen_tpu_torch/ops/lstm_cuda.py: the plain
version of csrc/lstm_bwd.cu and the autograd Function `LstmDirection`)
against the JAX package: jax.vjp of the fused Pallas kernel in interpret
mode at bf16, and jax.grad of the XLA scan at f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.models import bilstm as jbilstm
from eesen_tpu.ops.lstm_pallas import lstm_direction_fused_tm
from eesen_tpu_torch.models import bilstm as tbilstm
from eesen_tpu_torch.ops import lstm_cuda

PH = ("phole_i_c", "phole_f_c", "phole_o_c")


def setup(t=11, b=3, d=6, h=5, seed=0):
    """JAX parameters, time-major inputs with mixed lengths (one row of
    length 0) and a cotangent for the m carry."""
    cfg = jbilstm.BiLstmConfig(input_dim=d, cell_dim=h,
                               compute_dtype=jnp.float32)
    p = jbilstm.init_bilstm_layer(jax.random.PRNGKey(seed), cfg)["fw"]
    p = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, b, d)).astype(np.float32)
    lens = np.array([t, t - 4, 0][:b])
    mask = (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)
    gm = rng.standard_normal((t, b, h)).astype(np.float32)
    return cfg, p, x, mask, gm


def torch_weights(p, dtype):
    d, _, h = p["w_gifo_x"].shape
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return dict(
        w_x=t(p["w_gifo_x"]).reshape(d, 4 * h).to(dtype),
        bias=t(p["bias"]).reshape(4 * h),
        w_m=t(p["w_gifo_m"]).reshape(h, 4 * h).to(dtype),
        ph=t(np.stack([p[k] for k in PH])),
    )


@pytest.mark.parametrize("state_bf16", [False, True])
@pytest.mark.parametrize("seed,block_t", [(0, 4), (1, 3)])
def test_bwd_ref_matches_fused_kernel_vjp(seed, block_t, state_bf16):
    """T=11 runs several Pallas time blocks (and a padded tail).  Both
    sides recompute c_raw from the bf16 gates and round dgifo to bf16 for
    the products, but a last-bit difference can flip a bf16 rounding, so
    the JAX package's own fused-gradient tolerances hold: rtol 5e-2 /
    atol 5e-3 on the weights, rtol 5e-2 / atol 2e-2 on dx
    (tests/test_lstm_pallas.py:137-144)."""
    _, p, x, mask, gm = setup(seed=seed)
    sdt = torch.bfloat16 if state_bf16 else torch.float32
    jdt = jnp.bfloat16 if state_bf16 else jnp.float32

    def f(xx, wx, b, wm, pi, pf, po):
        return lstm_direction_fused_tm(
            xx, jnp.asarray(mask), wx, b, wm, pi, pf, po, block_t=block_t,
            interpret=True, state_bf16=state_bf16,
        )

    prim = (jnp.asarray(x), p["w_gifo_x"], p["bias"], p["w_gifo_m"],
            *(p[k] for k in PH))
    _, vjp = jax.vjp(f, *prim)
    dx_j, dwx_j, db_j, dwm_j, *dph_j = vjp(jnp.asarray(gm).astype(jdt))

    w = torch_weights(p, torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    mt = torch.from_numpy(mask)
    m, c, gates = lstm_cuda.lstm_direction_ref(
        xt, mt, **w, state_bf16=state_bf16, with_residuals=True)
    assert gates.dtype == torch.bfloat16 and c.dtype == m.dtype == sdt
    dx, dwx, dwm, db, dph = lstm_cuda.lstm_direction_bwd(
        xt, mt, gates, c, m, torch.from_numpy(gm).to(sdt), w["w_x"],
        w["w_m"], w["ph"])
    assert dx.dtype == torch.bfloat16
    d, h = x.shape[2], gm.shape[2]
    wt = dict(rtol=5e-2, atol=5e-3)
    np.testing.assert_allclose(dwx.numpy(), np.asarray(dwx_j).reshape(
        d, 4 * h), **wt)
    np.testing.assert_allclose(dwm.numpy(), np.asarray(dwm_j).reshape(
        h, 4 * h), **wt)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j).reshape(-1),
                               **wt)
    np.testing.assert_allclose(dph.numpy(), np.stack(
        [np.asarray(a) for a in dph_j]), **wt)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(dx_j),
                               rtol=5e-2, atol=2e-2)


@pytest.mark.parametrize("seed", [0, 2])
def test_function_f32_grads_match_xla_scan(seed):
    """The autograd Function (forward with residuals, plain backward on
    the CPU) against jax.grad of the XLA scan at f32: the same arithmetic,
    float32 sums in another order (rtol 1e-4 / atol 1e-6)."""
    cfg, p, x, mask, gm = setup(seed=seed, t=9, b=3, d=4, h=6)

    def loss_j(pp, xx):
        ms = jbilstm._direction_scan(pp, xx, jnp.asarray(mask), cfg, None)
        return jnp.sum(ms * gm)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    g_j, gx_j = jax.grad(loss_j, argnums=(0, 1))(jp, jnp.asarray(x))

    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    tcfg = tbilstm.BiLstmConfig(input_dim=4, cell_dim=6,
                                compute_dtype=torch.float32)
    before = lstm_cuda.bwd_launches
    ms = tbilstm._direction_scan(tp, xt, torch.from_numpy(mask), tcfg)
    assert ms.grad_fn is not None
    grads = torch.autograd.grad((ms * torch.from_numpy(gm)).sum(),
                                [xt, *tp.values()])
    assert lstm_cuda.bwd_launches == before      # the CPU launches nothing
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j),
                               rtol=1e-4, atol=1e-6)
    for k, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_function_keeps_f32_weight_grads_under_bf16():
    """Weights given in float32 are cast inside the Function, so their
    gradients come back float32 (not rounded to bf16), as the JAX
    kernel's custom VJP returns them."""
    _, p, x, mask, gm = setup(seed=3)
    w = {k: v.requires_grad_() for k, v in
         torch_weights(p, torch.float32).items()}
    m = lstm_cuda.lstm_direction(torch.from_numpy(x).to(torch.bfloat16),
                                 torch.from_numpy(mask), **w)
    grads = torch.autograd.grad((m * torch.from_numpy(gm)).sum(),
                                list(w.values()))
    assert all(g.dtype == torch.float32 for g in grads)
    # some entry is not a bf16 value: the gradient was not rounded
    assert any(not torch.equal(g, g.to(torch.bfloat16).float())
               for g in grads)


def test_bwd_ref_single_step_and_zero_rows():
    """T=1 (m_prev is zero everywhere, so dW_m is zero) and an all-padded
    batch (every gradient zero)."""
    _, p, x, mask, gm = setup(seed=4, t=1)
    w = torch_weights(p, torch.float32)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    m, c, gates = lstm_cuda.lstm_direction_ref(xt, mt, **w,
                                               with_residuals=True)
    _, _, dwm, _, _ = lstm_cuda.lstm_direction_bwd_ref(
        xt, mt, gates, c, m, torch.from_numpy(gm), w["w_x"], w["w_m"],
        w["ph"])
    assert torch.all(dwm == 0)
    zero = torch.zeros_like(mt)
    m, c, gates = lstm_cuda.lstm_direction_ref(xt, zero, **w,
                                               with_residuals=True)
    out = lstm_cuda.lstm_direction_bwd_ref(
        xt, zero, gates, c, m, torch.from_numpy(gm), w["w_x"], w["w_m"],
        w["ph"])
    assert all(torch.all(g == 0) for g in out)
