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
    """xw, mask (a full row, a short row, a row of length 0), W_m, ph and
    a cotangent of the m carry, as numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    lens = np.array([t, t - 4, 0][:b])
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
