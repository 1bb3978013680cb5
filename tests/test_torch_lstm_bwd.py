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


def tma_box(arr, rows, cols, r0, c0, h, w):
    """The [h, w] box at (r0, c0) of a [rows, cols] view of arr as a TMA
    load reads it: zero where it leaves the view."""
    out = np.zeros((h, w), np.float32)
    r1, c1 = min(rows, r0 + h), min(cols, c0 + w)
    if r1 > r0 and c1 > c0:
        out[:r1 - r0, :c1 - c0] = arr[r0:r1, c0:c1]
    return out


def tiled_product(a, a_mn, b, b_mn, b_k0, m, n, k, splits, tile):
    """The product kernel (csrc/gemm_wgmma.cu) in float32 numpy: A(m, k) =
    a[m, k] or a[k, m] (a_mn), B(k, n) = b[b_k0 + k, n] (b_mn) or b[n,
    b_k0 + k], read in boxes of its tile with the tensor maps' zero fill
    past M, N and K; split over k into `splits` slices of whole k steps,
    each a partial, the partials summed in the order z = 0..Z-1."""
    bm, bn, bk = tile
    ks = -(-(-(-k // bk)) // splits) * bk
    parts = np.zeros((splits, m, n), np.float32)
    for z in range(splits):
        for m0 in range(0, m, bm):
            for n0 in range(0, n, bn):
                acc = np.zeros((bm, bn), np.float32)
                for k0 in range(z * ks, min(k, (z + 1) * ks), bk):
                    at = tma_box(a, k, m, k0, m0, bk, bm).T if a_mn else \
                        tma_box(a, m, k, m0, k0, bm, bk)
                    bt = tma_box(b, b_k0 + k, n, b_k0 + k0, n0, bk, bn) \
                        if b_mn else \
                        tma_box(b, n, b_k0 + k, n0, b_k0 + k0, bn, bk).T
                    acc += at @ bt
                parts[z, m0:m0 + bm, n0:n0 + bn] = \
                    acc[:min(bm, m - m0), :min(bn, n - n0)]
    out = parts[0].copy()
    for z in range(1, splits):
        out += parts[z]
    return out


@pytest.mark.parametrize("tile,splits", [
    (lstm_cuda.GEMM_TILE, 1),    # the kernel's tile: one ragged box each way
    (lstm_cuda.GEMM_TILE, 3),    # K = T*B < one k step: two empty slices
    ((8, 8, 4), 1),              # many boxes, ragged at every edge
    ((8, 8, 4), 3),
    ((16, 8, 8), 5),
])
def test_tiled_product_model_matches_plain(tile, splits):
    """How kernel 3's bf16 products feed the product kernel, which cannot
    run here: x read as the transposed A of dW_x, m as that of dW_m (rows
    [0, T*B-B)) against dgifo from row B by the start coordinate, W_x as
    the transposed B of dx; boxes zero-filled at the edges and k-split
    partials summed in order.  The numpy model above gives
    lstm_direction_bwd_ref's dx, dW_x and dW_m, at f32 with D and H not
    multiples of 8, to float32 rounding in another order (rtol 1e-4 /
    atol 1e-5, the card tests' f32 tolerance)."""
    t, b, d, h = 11, 3, 13, 5
    rng = np.random.default_rng(splits)
    u = lambda *s: rng.uniform(-0.5, 0.5, s).astype(np.float32)
    mask = (np.arange(t)[:, None] < np.array([t, 6, 0])[None]).astype(
        np.float32)
    x, w_x, bias, w_m, ph = u(t, b, d), u(d, 4 * h), u(4 * h), u(h, 4 * h), \
        u(3, h)
    tt = torch.from_numpy
    m, c, gates = lstm_cuda.lstm_direction_ref(
        tt(x), tt(mask), tt(w_x), tt(bias), tt(w_m), tt(ph),
        with_residuals=True)
    gm = tt(rng.standard_normal((t, b, h)).astype(np.float32))
    want = lstm_cuda.lstm_direction_bwd_ref(
        tt(x), tt(mask), gates, c, m, gm, tt(w_x), tt(w_m), tt(ph))
    dgifo = lstm_cuda.lstm_direction_bwd_rec_ref(
        tt(x), tt(mask), gates, c, gm, tt(w_m), tt(ph))[0].numpy()
    tb, g = t * b, 4 * h
    dg, xs, ms = dgifo.reshape(tb, g), x.reshape(tb, d), \
        m.numpy().reshape(tb, h)
    got = {
        "dx": tiled_product(dg, False, w_x, False, 0, tb, d, g, splits, tile),
        "dw_x": tiled_product(xs, True, dg, True, 0, d, g, tb, splits, tile),
        "dw_m": tiled_product(ms, True, dg, True, b, h, g, tb - b, splits,
                              tile),
    }
    for name, w in zip(("dx", "dw_x", "dw_m"), want):
        np.testing.assert_allclose(got[name].reshape(w.shape), w.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("a_mn,b_mn", [(False, True), (True, True),
                                       (False, False), (True, False)])
@pytest.mark.parametrize("splits,b_k0,bias", [(1, 0, True), (3, 5, False)])
def test_gemm_bf16_plain_version_matches_model(a_mn, b_mn, splits, b_k0,
                                               bias):
    """gemm_bf16 on a CPU tensor (its plain version) in the four operand
    layouts gives the model's k-slice partials: bf16 operands, float32
    sums in another order (rtol 1e-5 / atol 1e-5), the bias in each."""
    m, n, k = 21, 19, 150
    rng = np.random.default_rng(splits + b_k0)
    f = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(
        np.float32)).bfloat16()
    a = f(*((k, m) if a_mn else (m, k)))
    b = f(*((b_k0 + k, n) if b_mn else (n, b_k0 + k)))
    bv = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)) \
        if bias else None
    got = lstm_cuda.gemm_bf16(a, b, a_mn=a_mn, b_mn=b_mn, b_k0=b_k0,
                              bias=bv, splits=splits)
    got = got.sum(0) if splits > 1 else got
    want = tiled_product(a.float().numpy(), a_mn, b.float().numpy(), b_mn,
                         b_k0, m, n, k, splits, lstm_cuda.GEMM_TILE)
    if bias:
        want = want + bv.numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
