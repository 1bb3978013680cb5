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


def cluster_rec_model(mask, gates, c, gm, w_m, ph, plan):
    """Kernel 3's reverse recurrence (csrc/lstm_bwd.cu lstm_bwd_rec_kernel)
    on its f32 path, in float32 numpy, with its partition: a cluster of
    plan.cluster CTAs per plan.rows batch rows, CTA q owning units
    [q*U, (q+1)*U) and reading its slice of W_m as `bwd_weight_slices`
    lays it out; each step every CTA's partial dm for all H units is
    scattered into the receive slots of the unit owners, and each owner
    sums its C slots in the order q = 0..C-1.  Returns dgifo [T, B, 4H]
    and the per-row sums [B, 7H] of (dgifo, di*c_prev, df*c_prev,
    do*c_raw)."""
    f32 = np.float32
    t_max, b, h = gm.shape
    cl, u, rows = plan.cluster, plan.units, plan.rows
    wsl = lstm_cuda.bwd_weight_slices(torch.from_numpy(w_m), plan,
                                      False).numpy()        # [C, 4U, H]
    ph_i, ph_f, ph_o = (np.pad(ph[k], (0, cl * u - h)) for k in range(3))
    dgifo = np.zeros((t_max, b, 4 * h), f32)
    sums = np.zeros((b, 7 * h), f32)
    for b0 in range(0, b, rows):
        nr = min(rows, b - b0)
        rs = slice(b0, b0 + nr)
        recv = np.zeros((2, cl, cl, nr, u), f32)      # [buf, owner, slot]
        dc = np.zeros((cl, nr, u), f32)
        dmp = np.zeros((cl, nr, u), f32)
        acc = np.zeros((cl, 7, nr, u), f32)
        for t in range(t_max - 1, -1, -1):
            op = np.zeros((cl, nr, 4 * u), f32)
            for q in range(cl):
                nu = max(0, min(u, h - q * u))
                if nu == 0:
                    continue
                us = slice(q * u, q * u + nu)
                dm_in = np.zeros((nr, nu), f32)
                if t + 1 < t_max:
                    for p in range(cl):               # the fixed order
                        dm_in = dm_in + recv[t & 1, q, p, :, :nu]
                gt = gates[t, rs]
                gg, ig = gt[:, us], gt[:, h:][:, us]
                fg, og = gt[:, 2 * h:][:, us], gt[:, 3 * h:][:, us]
                c_prev = c[t - 1, rs, us] if t > 0 else np.zeros_like(gg)
                c_raw = fg * c_prev + ig * gg
                mt = mask[t, rs][:, None]
                tanh_c = np.tanh(c_raw)
                dm_total = gm[t, rs, us] + (dm_in + dmp[q, :, :nu])
                dm_raw = dm_total * mt
                dc_in = dc[q, :, :nu]
                dc_raw = dc_in * mt
                do_ = dm_raw * tanh_c
                dc_raw = dc_raw + dm_raw * og * (f32(1) - tanh_c * tanh_c)
                do_pre = do_ * og * (f32(1) - og)
                dc_raw = dc_raw + do_pre * ph_o[us]
                di_pre = dc_raw * gg * ig * (f32(1) - ig)
                df_pre = dc_raw * c_prev * fg * (f32(1) - fg)
                dg_pre = dc_raw * ig * (f32(1) - gg * gg)
                dc[q, :, :nu] = (dc_raw * fg + di_pre * ph_i[us]
                                 + df_pre * ph_f[us] + dc_in * (f32(1) - mt))
                dmp[q, :, :nu] = dm_total * (f32(1) - mt)
                for g, d in enumerate((dg_pre, di_pre, df_pre, do_pre)):
                    dgifo[t, rs, g * h + q * u:g * h + q * u + nu] = d
                    op[q, :, g * u:g * u + nu] = d
                    acc[q, g, :, :nu] += d
                acc[q, 4, :, :nu] += di_pre * c_prev
                acc[q, 5, :, :nu] += df_pre * c_prev
                acc[q, 6, :, :nu] += do_pre * c_raw
            if t == 0:
                break
            for q in range(cl):                       # the reduce-scatter
                part = op[q] @ wsl[q]                 # [nr, H]
                part = np.pad(part, ((0, 0), (0, cl * u - h)))
                for p in range(cl):
                    recv[(t - 1) & 1, p, q] = part[:, p * u:(p + 1) * u]
        for q in range(cl):
            nu = max(0, min(u, h - q * u))
            for k in range(7):
                sums[rs, k * h + q * u:k * h + q * u + nu] = acc[q, k, :, :nu]
    return dgifo, sums


@pytest.mark.parametrize("t,b,d,h", [
    (11, 3, 6, 5),       # 8 CTAs of one unit, three of them idle
    (6, 40, 4, 20),      # two clusters of rows; the last CTA owns no unit
    (7, 5, 3, 37),       # 8 CTAs of 5 units, the last with 2
])
def test_cluster_reduce_scatter_model_matches_plain(t, b, d, h):
    """The algorithm of kernel 3's cluster recurrence, which cannot run
    here: the numpy model above, at f32 with bwd_plan's partition, gives
    lstm_direction_bwd_ref's gradients (dx, dW_x and dW_m from its dgifo
    as the tiled products take them; db and dph from its per-row sums) to
    float32 rounding in another order: rtol 1e-4 / atol 1e-5, the card
    test's f32 tolerance."""
    rng = np.random.default_rng(t * b + h)
    u = lambda *s: rng.uniform(-0.5, 0.5, s).astype(np.float32)
    lens = rng.integers(0, t + 1, b)
    lens[0], lens[-1] = t, 0
    mask = (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)
    x, w_x, bias, w_m, ph = u(t, b, d), u(d, 4 * h), u(4 * h), u(h, 4 * h), \
        u(3, h)
    tt = torch.from_numpy
    m, c, gates = lstm_cuda.lstm_direction_ref(
        tt(x), tt(mask), tt(w_x), tt(bias), tt(w_m), tt(ph),
        with_residuals=True)
    gm = rng.standard_normal((t, b, h)).astype(np.float32)
    want = lstm_cuda.lstm_direction_bwd_ref(
        tt(x), tt(mask), gates, c, m, tt(gm), tt(w_x), tt(w_m), tt(ph))
    plan = lstm_cuda.bwd_plan(b, h, bf16=False)
    dgifo, sums = cluster_rec_model(mask, gates.numpy(), c.numpy(), gm, w_m,
                                    ph, plan)
    tot = sums.sum(0)
    dg2 = dgifo.reshape(t * b, 4 * h)
    m_prev = np.concatenate([np.zeros_like(m[:1]), m[:-1]]).reshape(t * b, h)
    got = (dg2 @ w_x.T, x.reshape(t * b, d).T @ dg2, m_prev.T @ dg2,
           tot[:4 * h], tot[4 * h:].reshape(3, h))
    for name, g, w in zip(("dx", "dw_x", "dw_m", "db", "dph"), got, want):
        np.testing.assert_allclose(g.reshape(w.shape), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
