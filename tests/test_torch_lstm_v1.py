"""The port's v1 LSTM route (eesen_tpu_torch/ops/lstm_v1_cuda.py: the plain
versions of kernels 4 and 5, the autograd Function `LstmScan`, and the
entries `_v1_direction_tm` and `lstm_direction_xproj`) against the JAX
package's `lstm_scan` and its entries, the Pallas kernels run in
interpret mode; and the route choice `lstm_cuda.fused_launch`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.models import bilstm as jbilstm
from eesen_tpu.ops import lstm_pallas as jlp
from eesen_tpu_torch.ops import lstm_cuda, lstm_v1_cuda

PH = ("phole_i_c", "phole_f_c", "phole_o_c")


def scan_inputs(seed, t=9, b=3, h=5):
    """xw, mask (a full row, a short row, a row of length 0, then for b > 3
    a row of 3 steps and one of t-1), W_m, ph and a cotangent of the m
    carry, as numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    lens = np.array([t, t - 4, 0, 3, t - 1][:b])
    mask = (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)
    return dict(xw=f(t, b, 4 * h), mask=mask, w_m=f(h, 4 * h, sc=0.3),
                ph=f(3, h, sc=0.3), gm=f(t, b, h))


@pytest.mark.parametrize("seed", [0, 1])
def test_lstm_scan_matches_jax(seed):
    """Forward m carry and the gradients of (xw, W_m, ph).  Both sides
    round the recurrent operand and dgifo to bf16 and sum in float32; a
    last-bit difference in the sums can flip one bf16 rounding, so the
    JAX bf16 tolerances: rtol 2e-2 / atol 2e-3 forward
    (tests/test_lstm_pallas.py:51) and rtol 5e-2 / atol 5e-3 on the
    gradients (:78)."""
    a = scan_inputs(seed)
    j = {k: jnp.asarray(v) for k, v in a.items()}

    def f(xw, w_m, ph):
        return jlp.lstm_scan(xw, j["mask"][:, :, None], w_m, ph, True)

    m_j, vjp = jax.vjp(f, j["xw"], j["w_m"], j["ph"])
    g_j = vjp(j["gm"])

    t = {k: torch.from_numpy(v).requires_grad_(k in ("xw", "w_m", "ph"))
         for k, v in a.items()}
    m_t = lstm_v1_cuda.lstm_scan(t["xw"], t["mask"], t["w_m"], t["ph"])
    assert m_t.dtype == torch.float32
    g_t = torch.autograd.grad((m_t * t["gm"]).sum(),
                              [t["xw"], t["w_m"], t["ph"]])
    np.testing.assert_allclose(m_t.detach().numpy(), np.asarray(m_j),
                               rtol=2e-2, atol=2e-3)
    for name, g, w in zip(("dxw", "dw_m", "dph"), g_t, g_j):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-2,
                                   atol=5e-3, err_msg=name)
    # the length-0 row: m stays zero, and no gradient reaches its xw
    assert torch.all(m_t[:, 2] == 0) and torch.all(g_t[0][:, 2] == 0)


def test_scan_residuals_are_consistent():
    """The plain kernel 4 at f32-exact inputs: m = o*tanh(c_raw) at valid
    steps, the carries frozen at padded ones, gates in bf16."""
    a = scan_inputs(3)
    xw, mask, w_m, ph = (torch.from_numpy(a[k]) for k in
                         ("xw", "mask", "w_m", "ph"))
    m, c, c_raw, gates = lstm_v1_cuda.lstm_scan_fwd(
        xw, mask, w_m.to(torch.bfloat16), ph)
    assert gates.dtype == torch.bfloat16
    h = m.shape[2]
    o = gates[..., 3 * h:].float()
    valid = mask[:, :, None] > 0
    want = o * torch.tanh(c_raw)
    # o is stored in bf16: one bf16 rounding of the factor
    torch.testing.assert_close(m[valid.expand_as(m)],
                               want[valid.expand_as(m)], rtol=8e-3,
                               atol=1e-6)
    np.testing.assert_array_equal(m[5:, 1].numpy(), m[4:5, 1].expand(
        4, -1).numpy())
    np.testing.assert_array_equal(c[5:, 1].numpy(), c[4:5, 1].expand(
        4, -1).numpy())


def direction_setup(seed=0, t=8, b=3, d=5, h=6):
    cfg = jbilstm.BiLstmConfig(input_dim=d, cell_dim=h,
                               compute_dtype=jnp.float32)
    p = jbilstm.init_bilstm_layer(jax.random.PRNGKey(seed), cfg)["fw"]
    p = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, b, d)).astype(np.float32)
    lens = np.array([t, t - 3, 0][:b])
    mask = (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)
    return p, x, mask


@pytest.mark.parametrize("seed", [0, 2])
def test_v1_direction_matches_jax(seed):
    """`_v1_direction_tm`, value and gradients of x and every parameter,
    against the JAX function in interpret mode.  Both run the projection
    in bf16 operands with f32 sums, the recurrence in bf16; the
    tolerance is that of tests/test_lstm_pallas.py:184-215 (rtol 3e-2 /
    atol 3e-3)."""
    p, x, mask = direction_setup(seed)

    def f_j(pp, xx):
        m = jlp._v1_direction_tm(
            xx, jnp.asarray(mask), pp["w_gifo_x"], pp["bias"],
            pp["w_gifo_m"], *(pp[k] for k in PH), interpret=True)
        return jnp.sum(m * jnp.asarray(mask)[:, :, None] * 0.1)

    v_j, (g_j, gx_j) = jax.value_and_grad(f_j, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))

    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in
          p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    mt = torch.from_numpy(mask)
    m = lstm_v1_cuda._v1_direction_tm(
        xt, mt, tp["w_gifo_x"], tp["bias"], tp["w_gifo_m"],
        *(tp[k] for k in PH))
    v_t = (m * mt[:, :, None] * 0.1).sum()
    grads = torch.autograd.grad(v_t, [xt, *tp.values()])
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=3e-2)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j),
                               rtol=3e-2, atol=3e-3)
    for k, g in zip(tp, grads[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k]),
                                   rtol=3e-2, atol=3e-3, err_msg=k)


def test_xproj_runner_matches_jax():
    """`lstm_direction_xproj` (batch-major, x_proj [B, T, 4, H]) against
    `lstm_direction_pallas`: m at valid steps and the gradients of every
    parameter through the projection, as tests/test_lstm_pallas.py:55-79
    (rtol 3e-2 / atol 3e-3)."""
    p, x, mask = direction_setup(1, t=7, b=3, d=4, h=5)
    x_bm, mask_bm = np.moveaxis(x, 0, 1), np.ascontiguousarray(mask.T)

    def f_j(pp):
        xp = jnp.einsum("btd,dgh->btgh", jnp.asarray(x_bm),
                        pp["w_gifo_x"]) + pp["bias"]
        m = jlp.lstm_direction_pallas(
            xp, jnp.asarray(mask_bm), pp["w_gifo_m"],
            *(pp[k] for k in PH), interpret=True)
        return jnp.sum((m * jnp.asarray(mask_bm)[:, :, None]) ** 2), m

    (v_j, m_j), g_j = jax.value_and_grad(f_j, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()})

    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in
          p.items()}
    mt = torch.from_numpy(mask_bm)
    xp = torch.einsum("btd,dgh->btgh", torch.from_numpy(x_bm),
                      tp["w_gifo_x"]) + tp["bias"]
    m = lstm_v1_cuda.lstm_direction_xproj(xp, mt, tp["w_gifo_m"],
                                          *(tp[k] for k in PH))
    assert m.shape == (3, 7, 5)
    v_t = ((m * mt[:, :, None]) ** 2).sum()
    grads = torch.autograd.grad(v_t, list(tp.values()))
    valid = mask_bm[:, :, None]
    np.testing.assert_allclose(m.detach().numpy() * valid,
                               np.asarray(m_j) * valid, rtol=3e-2, atol=3e-3)
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=3e-2)
    for k, g in zip(tp, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k]),
                                   rtol=3e-2, atol=3e-3, err_msg=k)


def test_v1_route_matches_fused_plain_route():
    """The two routes on the CPU, bf16 both: the v1 entry against the
    plain version of the fused kernels, from the same inputs and f32
    weights (the comparison chip_smoke.py makes on the card)."""
    p, x, mask = direction_setup(4, t=10, b=3, d=7, h=9)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    xt, mt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask)
    m_v1 = lstm_v1_cuda._v1_direction_tm(
        xt, mt, tp["w_gifo_x"], tp["bias"], tp["w_gifo_m"],
        *(tp[k] for k in PH))
    m_fused = lstm_cuda.lstm_direction(
        xt, mt, tp["w_gifo_x"].reshape(7, 36), tp["bias"].reshape(36),
        tp["w_gifo_m"].reshape(9, 36), torch.stack([tp[k] for k in PH]))
    torch.testing.assert_close(m_v1, m_fused, rtol=2e-2, atol=2e-3)


def test_scan_with_no_steps_or_rows():
    for t, b in ((0, 2), (3, 0)):
        xw = torch.zeros((t, b, 8), requires_grad=True)
        m = lstm_v1_cuda.lstm_scan(xw, torch.ones((t, b)),
                                   torch.zeros((2, 8)), torch.zeros((3, 2)))
        assert m.shape == (t, b, 2)
        (g,) = torch.autograd.grad(m.sum(), [xw], allow_unused=True)
        assert g is None or g.shape == xw.shape


@pytest.mark.parametrize("b,d,h", [
    (128, 360, 320), (128, 1280, 640), (8, 1152, 1024), (1, 64, 512),
    (8, 1152, 1025), (8, 1152, 1152), (4, 60000, 64), (4, 26000, 1024),
])
def test_fused_launch_refuses_exactly_past_the_limits(b, d, h):
    """None exactly where the route has always refused: the thread-per-unit
    kernel 3's split*H threads above 1024 (i.e. any H > 1024) or its shared
    memory at its rows (`fits` below).  Kernels 1 and 3 now run cluster
    recurrences that keep what fits of W_m resident and take every H up to
    1024 at any input width, so the accepted set holds every shape that
    the one-block kernel 1 took, whose shared memory grew with D + H, and
    `fused_launch` keeps the 1024 limit.  Host arithmetic only."""
    split = max(1, min(4, 1024 // h))
    rows = min(2, b)
    old_fwd = 4 * (1 * (d + h) + 2 * h + split * 4 * h)   # one-block kernel 1
    bwd = 4 * rows * (13 * h + split * h)
    fits = split * h <= 1024 and bwd <= 232448
    for bf16 in (True, False):
        got = lstm_cuda.fused_launch(b, d, h, bf16)
        assert (got is not None) == fits
        if split * h <= 1024 and old_fwd <= 232448 and bwd <= 232448:
            assert got is not None
        if got is not None:
            q = got.bwd
            assert q.cluster in (8, 16) and q.units * q.cluster >= h
            assert lstm_cuda.bwd_smem_bytes(*q, bf16) <= 232448
            p = got.fwd
            assert p.cluster in (8, 16) and p.units * p.cluster >= h
            assert lstm_cuda.fwd_smem_bytes(
                h, p.rows, p.units, p.kres, bf16) <= 232448


_BF, _F32 = torch.bfloat16, torch.float32


def cluster_fwd_model(xw, mask, w_m, ph, cluster, rows):
    """Kernel 4's cluster design (csrc/lstm_fwd.cu lstm_rec_kernel with a
    c_raw output) in float32 torch, with its partition: a cluster of
    `cluster` CTAs per `rows` batch rows, CTA q owning hidden units
    [q*U, (q+1)*U) (U = fwd_units) with their four gate columns, each step
    its pre-activations bf16(m_{t-1}) . W_m[:, its 4U columns] in float32,
    then its units' gates, freeze and outputs; bf16(m_t) goes into every
    CTA's next operand.  Returns (m, c, c_raw, gates) as the kernel."""
    t_max, b, g4 = xw.shape
    h = g4 // 4
    u = lstm_cuda.fwd_units(h, cluster)
    wm = w_m.to(_BF).to(_F32)
    m_out, c_out, craw_out = (torch.zeros((t_max, b, h)) for _ in range(3))
    gates = torch.zeros((t_max, b, 4 * h), dtype=_BF)
    for b0 in range(0, b, rows):
        rs = slice(b0, min(b, b0 + rows))
        nr = rs.stop - b0
        op = torch.zeros((nr, h))                  # bf16(m_{t-1}) in f32
        cs, ms = torch.zeros((nr, h)), torch.zeros((nr, h))
        for t in range(t_max):
            nxt = torch.zeros((nr, h))
            for q in range(cluster):
                nu = max(0, min(u, h - q * u))
                if nu == 0:
                    continue
                us = slice(q * u, q * u + nu)
                cols = torch.cat([torch.arange(g * h + q * u,
                                               g * h + q * u + nu)
                                  for g in range(4)])
                pre = (op @ wm[:, cols]).view(nr, 4, nu)
                x4 = xw[t, rs].view(nr, 4, h)[:, :, us]
                c_prev, m_prev = cs[:, us], ms[:, us]
                gg = torch.tanh(x4[:, 0] + pre[:, 0])
                ig = torch.sigmoid(x4[:, 1] + pre[:, 1] + c_prev * ph[0, us])
                fg = torch.sigmoid(x4[:, 2] + pre[:, 2] + c_prev * ph[1, us])
                c_raw = fg * c_prev + ig * gg
                og = torch.sigmoid(x4[:, 3] + pre[:, 3] + c_raw * ph[2, us])
                m_raw = og * torch.tanh(c_raw)
                mt = mask[t, rs][:, None]
                c_new = c_raw * mt + c_prev * (1.0 - mt)
                m_new = m_raw * mt + m_prev * (1.0 - mt)
                cs[:, us], ms[:, us] = c_new, m_new
                m_out[t, rs, us], c_out[t, rs, us] = m_new, c_new
                craw_out[t, rs, us] = c_raw
                for g, v in enumerate((gg, ig, fg, og)):
                    gates[t, rs, g * h + q * u:g * h + q * u + nu] = v.to(_BF)
                nxt[:, us] = m_new.to(_BF).to(_F32)
            op = nxt
    return m_out, c_out, craw_out, gates


def cluster_bwd_model(mask, gates, c_raw, c, gm, w_m, ph, cluster, rows):
    """Kernel 5's cluster design (csrc/lstm_bwd.cu lstm_bwd_rec_kernel,
    its v1 instance) in float32 torch, with its partition: CTA q owns
    units [q*U, (q+1)*U) (U = bwd_units) and reads its slice of W_m as
    `bwd_weight_slices` lays it out in bf16; each step, from T-1 down, it
    reads the STORED c_raw, writes its units' dgifo unrounded into dxw,
    takes bf16(dgifo) as the operand of its partial dm over all H units,
    and scatters that into the receive slots of the units' owners, who
    sum their C slots in the order q = 0..C-1.  Returns dxw [T, B, 4H]."""
    t_max, b, h = gm.shape
    u = lstm_cuda.bwd_units(h, cluster, True)
    plan = lstm_cuda.BwdPlan(cluster, rows, u, 0)
    wsl = lstm_cuda.bwd_weight_slices(w_m.to(_BF), plan, True)
    wsl = wsl[:, :h, :4 * u].to(_F32)              # [C, H, 4U]: u', j
    pad = cluster * u - h
    dxw = torch.zeros((t_max, b, 4 * h))
    for b0 in range(0, b, rows):
        rs = slice(b0, min(b, b0 + rows))
        nr = rs.stop - b0
        recv = torch.zeros((2, cluster, cluster, nr, u))   # buf, owner, slot
        dc, dmp = torch.zeros((cluster, nr, u)), torch.zeros((cluster, nr, u))
        for t in range(t_max - 1, -1, -1):
            op = torch.zeros((cluster, nr, 4 * u))
            for q in range(cluster):
                nu = max(0, min(u, h - q * u))
                if nu == 0:
                    continue
                us = slice(q * u, q * u + nu)
                dm_in = torch.zeros((nr, nu))
                if t + 1 < t_max:
                    for p in range(cluster):               # the fixed order
                        dm_in = dm_in + recv[t & 1, q, p, :, :nu]
                gt = gates[t, rs].to(_F32)
                gg, ig, fg, og = (gt[:, k * h:(k + 1) * h][:, us]
                                  for k in range(4))
                c_prev = c[t - 1, rs, us] if t > 0 else torch.zeros((nr, nu))
                tanh_c = torch.tanh(c_raw[t, rs, us])
                mt = mask[t, rs][:, None]
                dm_total = gm[t, rs, us] + (dm_in + dmp[q, :, :nu])
                dm_raw = dm_total * mt
                dc_in = dc[q, :, :nu]
                dc_raw = dc_in * mt
                do_ = dm_raw * tanh_c
                dc_raw = dc_raw + dm_raw * og * (1.0 - tanh_c * tanh_c)
                do_pre = do_ * og * (1.0 - og)
                dc_raw = dc_raw + do_pre * ph[2, us]
                di_pre = dc_raw * gg * ig * (1.0 - ig)
                df_pre = dc_raw * c_prev * fg * (1.0 - fg)
                dg_pre = dc_raw * ig * (1.0 - gg * gg)
                dc[q, :, :nu] = (dc_raw * fg + di_pre * ph[0, us]
                                 + df_pre * ph[1, us] + dc_in * (1.0 - mt))
                dmp[q, :, :nu] = dm_total * (1.0 - mt)
                for g, d in enumerate((dg_pre, di_pre, df_pre, do_pre)):
                    dxw[t, rs, g * h + q * u:g * h + q * u + nu] = d
                    op[q, :, g * u:g * u + nu] = d.to(_BF).to(_F32)
            if t == 0:
                break
            for q in range(cluster):                       # reduce-scatter
                part = torch.nn.functional.pad(op[q] @ wsl[q].t(), (0, pad))
                for p in range(cluster):
                    recv[(t - 1) & 1, p, q] = part[:, p * u:(p + 1) * u]
    return dxw


# (T, B, H, rows): with C=4 the last CTA owns no unit (H=10) or one (H=13);
# rows=2 cuts B=5 into three clusters of rows, the last ragged
MODEL_CASES = [(9, 3, 10, 16), (7, 5, 13, 2)]


@pytest.mark.parametrize("t,b,h,rows", MODEL_CASES)
def test_cluster_fwd_model_matches_plain(t, b, h, rows):
    """The algorithm of kernel 4's cluster design, which cannot run here:
    the model above at C=4, split by units, gives lstm_scan_fwd_ref's m,
    c, c_raw and gates.  Both round the same operand to bf16 and sum in
    float32, in another order: rtol 1e-5 / atol 1e-6 (float32 rounding),
    the gates to one bf16 step (rtol 2**-8)."""
    a = scan_inputs(10 * t + b, t=t, b=b, h=h)
    xw, mask, w_m, ph = (torch.from_numpy(a[k]) for k in
                         ("xw", "mask", "w_m", "ph"))
    got = cluster_fwd_model(xw, mask, w_m, ph, 4, rows)
    want = lstm_v1_cuda.lstm_scan_fwd_ref(xw, mask, w_m.to(_BF), ph)
    for name, g, w in zip(("m", "c", "c_raw"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6, msg=name)
    torch.testing.assert_close(got[3].float(), want[3].float(),
                               rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("t,b,h,rows", MODEL_CASES)
def test_cluster_bwd_model_matches_plain_and_jax(t, b, h, rows):
    """The algorithm of kernel 5's cluster design, which cannot run here:
    the model above at C=4, on the plain kernel 4's residuals, gives
    lstm_scan_bwd_ref's dxw to float32 rounding in another order (rtol
    1e-5 / atol 1e-6: both take bf16(dgifo) and bf16 W_m with float32
    sums), and the JAX `lstm_scan` VJP's dxw (Pallas kernels in interpret
    mode, their own residuals) at the JAX bf16 gradient tolerance, rtol
    5e-2 / atol 5e-3 (tests/test_lstm_pallas.py:78)."""
    a = scan_inputs(10 * t + b + 1, t=t, b=b, h=h)
    xw, mask, w_m, ph, gm = (torch.from_numpy(a[k]) for k in
                             ("xw", "mask", "w_m", "ph", "gm"))
    m, c, c_raw, gates = lstm_v1_cuda.lstm_scan_fwd_ref(xw, mask,
                                                        w_m.to(_BF), ph)
    got = cluster_bwd_model(mask, gates, c_raw, c, gm, w_m, ph, 4, rows)
    want = lstm_v1_cuda.lstm_scan_bwd_ref(mask, gates, c_raw, c, gm,
                                          w_m.to(_BF), ph)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    _, vjp = jax.vjp(lambda x: jlp.lstm_scan(x, j["mask"][:, :, None],
                                             j["w_m"], j["ph"], True),
                     j["xw"])
    (dxw_j,) = vjp(j["gm"])
    np.testing.assert_allclose(got.numpy(), np.asarray(dxw_j), rtol=5e-2,
                               atol=5e-3)
