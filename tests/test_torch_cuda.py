"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where torch.cuda.is_available() is false.
This file imports neither jax nor the JAX package, so it also runs on a
GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dedup_cases import CASES, make_case

from eesen_tpu_torch.decoder import beam as tbeam
from eesen_tpu_torch.decoder.arpa import arpa_to_fst
from eesen_tpu_torch.decoder.ctc_graph import build_lg, build_tlg, compile_lang
from eesen_tpu_torch.decoder.graph_compile import compile_graph
from eesen_tpu_torch.decoder.frame_skip import compact_blank_frames
from eesen_tpu_torch.models import bilstm as tbilstm
from eesen_tpu_torch.ops import (
    beam_cuda, build, ctc_cuda, lstm_cuda, lstm_v1_cuda,
)
from eesen_tpu_torch.ops.ctc import _ctc_prep, _final_states
from eesen_tpu_torch.utils.math import LOG_ZERO, LOG_ZERO_THRESHOLD
from eesen_tpu_torch.recipes.lm import estimate_bigram_arpa
from eesen_tpu_torch.recipes.synth_corpus import SynthConfig, make_lexicon

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def lstm_args(dev, dtype, t=13, b=3, d=24, h=32, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.uniform(-0.5, 0.5, s).astype(np.float32)).to(dev)
    lens = torch.tensor([t, t - 4, 5], device=dev)
    mask = (torch.arange(t, device=dev)[:, None] < lens[None]).float()
    return dict(x=f(t, b, d).to(dtype), mask=mask, w_x=f(d, 4 * h).to(dtype),
                bias=f(4 * h), w_m=f(h, 4 * h).to(dtype), ph=f(3, h))


@pytest.mark.parametrize("dtype,state_bf16,tol", [
    (torch.float32, False, (1e-5, 1e-5)),      # sums in another order
    (torch.bfloat16, False, (2e-2, 2e-3)),     # the JAX bf16 tolerance
    (torch.bfloat16, True, (2e-2, 2e-3)),
])
def test_lstm_kernel_matches_plain(dev, dtype, state_bf16, tol):
    args = lstm_args(dev, dtype)
    before = lstm_cuda.launches
    got = lstm_cuda.lstm_direction(**args, state_bf16=state_bf16,
                                   with_residuals=True)
    want = lstm_cuda.lstm_direction_ref(**args, state_bf16=state_bf16,
                                        with_residuals=True)
    torch.cuda.synchronize()
    assert lstm_cuda.launches == before + 1
    # m and c at the stated tolerance; the gates, in the dtype of x, at
    # the bf16 tolerance
    for g, w, (rtol, atol) in zip(got, want, (tol, tol, (2e-2, 2e-3))):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol)


def test_lstm_kernel_rejects_bad_inputs(dev):
    """Weights in the dtype of x or float32 are taken (float32 is cast);
    any other dtype is refused."""
    args = lstm_args(dev, torch.bfloat16)
    args["w_m"] = args["w_m"].half()
    with pytest.raises(ValueError):
        lstm_cuda.lstm_direction(**args)


def lstm_residuals(dev, dtype, state_bf16, seed=1):
    args = lstm_args(dev, dtype, seed=seed)
    m, c, gates = lstm_cuda.lstm_direction(**args, state_bf16=state_bf16,
                                           with_residuals=True)
    gm = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        m.shape).astype(np.float32)).to(dev, m.dtype)
    return dict(x=args["x"], mask=args["mask"], gates=gates, c=c, m=m,
                gm=gm, w_x=args["w_x"], w_m=args["w_m"], ph=args["ph"])


@pytest.mark.parametrize("dtype,state_bf16,tol", [
    (torch.float32, False, (1e-4, 1e-5)),      # sums in another order
    (torch.bfloat16, False, (5e-2, 5e-3)),     # the JAX fused-grad tolerance
    (torch.bfloat16, True, (5e-2, 5e-3)),
])
def test_lstm_bwd_kernel_matches_plain(dev, dtype, state_bf16, tol):
    inp = lstm_residuals(dev, dtype, state_bf16)
    before = lstm_cuda.bwd_launches
    got = lstm_cuda.lstm_direction_bwd(**inp)
    want = lstm_cuda.lstm_direction_bwd_ref(**inp)
    torch.cuda.synchronize()
    assert lstm_cuda.bwd_launches == before + 1
    # dx in the dtype of x at the dx tolerance (a bf16 rounding away)
    dx_tol = tol if dtype == torch.float32 else (5e-2, 2e-2)
    for name, g, w, (rtol, atol) in zip(
            ("dx", "dw_x", "dw_m", "db", "dph"), got, want,
            (dx_tol, tol, tol, tol, tol)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol, msg=name)


def test_lstm_direction_autograd_on_card(dev):
    """Gradients of the autograd Function on the card (both kernels)
    against the same Function on the CPU (both plain versions), f32."""
    args = lstm_args(dev, torch.float32, seed=2)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (13, 3, 32)).astype(np.float32))
    grads = []
    for d in (dev, torch.device("cpu")):
        a = {k: v.to(d).requires_grad_(k != "mask") for k, v in args.items()}
        m = lstm_cuda.lstm_direction(**a)
        loss = (m * a["mask"][:, :, None] * w.to(d)).sum()
        names = [k for k in a if k != "mask"]
        grads.append(torch.autograd.grad(loss, [a[k] for k in names]))
    for name, g, c in zip(names, *grads):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-5,
                                   msg=name)


def scan_args(dev, h, t=13, b=3, seed=3):
    """Kernel 4's inputs (xw f32; row 0 full length, the last row of b > 1
    of length 0, the rest in between) and a cotangent gm."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.standard_normal(s)).astype(np.float32)).to(dev)
    lens = rng.integers(1, t + 1, b)
    lens[0] = t
    if b > 1:
        lens[-1] = 0
    mask = (torch.arange(t)[:, None] < torch.from_numpy(lens)[None]).float()
    return dict(xw=f(t, b, 4 * h), mask=mask.to(dev),
                w_m=f(h, 4 * h, sc=0.05).to(torch.bfloat16),
                ph=f(3, h, sc=0.3)), f(t, b, h)


def scan_residuals(args, gm):
    """Kernel 5's inputs from kernel 4's run on `args`."""
    m, c, c_raw, gates = lstm_v1_cuda.lstm_scan_fwd(**args)
    return dict(mask=args["mask"], gates=gates, c_raw=c_raw, c=c, gm=gm,
                w_m=args["w_m"], ph=args["ph"])


def scan_step(args, m, c):
    """Kernel 4's plain step (lstm_scan_fwd_ref's) at every step at once,
    from the given m and c carries one step back (zero at t=0) instead of
    the plain version's own trajectory: (m, c, c_raw, gates)."""
    bf, f32 = torch.bfloat16, torch.float32
    h = args["w_m"].shape[0]
    ph = args["ph"]
    m_prev, c_prev = lstm_v1_cuda._shift(m), lstm_v1_cuda._shift(c)
    gifo = args["xw"] + torch.matmul(m_prev.to(bf).to(f32),
                                     args["w_m"].to(f32))
    g = torch.tanh(gifo[..., :h])
    i = torch.sigmoid(gifo[..., h:2 * h] + c_prev * ph[0])
    f = torch.sigmoid(gifo[..., 2 * h:3 * h] + c_prev * ph[1])
    c_raw = f * c_prev + i * g
    o = torch.sigmoid(gifo[..., 3 * h:] + c_raw * ph[2])
    mt = args["mask"][:, :, None]
    return (o * torch.tanh(c_raw) * mt + m_prev * (1.0 - mt),
            c_raw * mt + c_prev * (1.0 - mt), c_raw,
            torch.cat([g, i, f, o], dim=-1).to(bf))


def rel_l2(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.parametrize("b", [1, 8, 20, 128])
@pytest.mark.parametrize("h", [40, 640, 1152, 1664, 1672, 2624, 2632])
def test_lstm_scan_kernels_match_plain(dev, h, b):
    """Kernel 4 and kernel 5 on its residuals against their plain
    versions, on both sides of each cluster plan's limit (kernel 5's at
    H = 1664, kernel 4's at 2624): one launch each, of the design the host
    plan names.

    Kernel 4: each step's m, c, c_raw and gates against the plain step
    from the kernel's own carries, at the JAX bf16 tolerance rtol 2e-2 /
    atol 2e-3; the free-running plain version within 1e-2 relative L2
    and, up to H = 1152, elementwise at that tolerance too.  Past it these
    inputs make the recurrence amplify rounding: a 1e-6 relative change
    of xw moves the plain version itself by up to 1.6x that tolerance in
    9 steps at H = 2624 (0.76x at 1152, 0.35x at 640), so a free-running
    elementwise bound says nothing there.  Kernel 5: dxw at rtol 5e-2 /
    atol 2e-2, the dx tolerance of the fused gradients (the same change
    of gm moves the plain dxw by at most 0.1x of it)."""
    args, gm = scan_args(dev, h, t=9, b=b)
    assert lstm_v1_cuda.fwd_launch(b, h).design == (
        "cluster" if h <= 2624 else "thread_per_unit")
    assert lstm_v1_cuda.bwd_launch(b, h).design == (
        "cluster" if h <= 1664 else "thread_per_unit")
    before = (lstm_v1_cuda.launches, lstm_v1_cuda.bwd_launches)
    got = lstm_v1_cuda.lstm_scan_fwd(**args)
    want = lstm_v1_cuda.lstm_scan_fwd_ref(**args)
    step = scan_step(args, got[0], got[1])
    for name, g, w, st in zip(("m", "c", "c_raw", "gates"), got, want,
                              step):
        assert g.dtype == w.dtype == st.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), st.float(), rtol=2e-2,
                                   atol=2e-3, msg=lambda e: f"{name}: {e}")
        assert rel_l2(g, w) <= 1e-2, name
        if h <= 1152:
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=2e-3,
                                       msg=lambda e: f"{name}: {e}")
    m, c, c_raw, gates = got
    res = dict(mask=args["mask"], gates=gates, c_raw=c_raw, c=c, gm=gm,
               w_m=args["w_m"], ph=args["ph"])
    dxw = lstm_v1_cuda.lstm_scan_bwd(**res)
    dxw_ref = lstm_v1_cuda.lstm_scan_bwd_ref(**res)
    torch.cuda.synchronize()
    assert (lstm_v1_cuda.launches, lstm_v1_cuda.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert dxw.dtype == torch.float32
    torch.testing.assert_close(dxw, dxw_ref, rtol=5e-2, atol=2e-2)
    if b > 1:
        assert torch.all(dxw[:, -1] == 0)


@pytest.mark.parametrize("b,h", [(128, 640), (128, 1152), (8, 1152),
                                 (8, 1672), (3, 2632)])
def test_lstm_scan_kernels_are_deterministic(dev, b, h):
    """Kernels 4 and 5 sum in a fixed order (kernel 5's cluster sums its
    dm partials in the order q = 0..C-1) and use no float atomics: two
    calls on the same inputs give the same bits, in both designs."""
    args, gm = scan_args(dev, h, t=17, b=b, seed=4)
    first = [g.clone() for g in lstm_v1_cuda.lstm_scan_fwd(**args)]
    second = lstm_v1_cuda.lstm_scan_fwd(**args)
    res = scan_residuals(args, gm)
    dxw = [lstm_v1_cuda.lstm_scan_bwd(**res).clone() for _ in range(2)]
    torch.cuda.synchronize()
    for a, b2 in [*zip(first, second), dxw]:
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b2.view(torch.int16 if b2.dtype == torch.bfloat16
                                   else torch.int32))


@pytest.mark.parametrize("b,h,d", [(8, 320, 120), (128, 640, 64),
                                   (20, 1024, 48)])
def test_kernel_4_is_kernel_1s_recurrence(dev, b, h, d):
    """Kernel 4's cluster design is kernel 1's recurrence with c_raw
    written beside c: on kernel 1's own projection (the product kernel on
    the same operands, x.W_x + b) and its plan, kernel 4 gives kernel 1's
    m, c and gates bit for bit (kernel 1 with a null c_raw pointer, bf16
    compute, f32 state), and c_raw is the cell the gates and c carry give
    back at valid steps."""
    args = shape_args(dev, torch.bfloat16, b, h, d=d, seed=h)
    t = args["x"].shape[0]
    m1, c1, g1 = lstm_cuda.lstm_direction(**args, with_residuals=True)
    xw = lstm_cuda.gemm_bf16(args["x"].reshape(t * b, d), args["w_x"],
                             bias=args["bias"]).reshape(t, b, 4 * h)
    assert lstm_v1_cuda.fwd_launch(b, h) == ("cluster",
                                             lstm_cuda.fwd_plan(b, h))
    m4, c4, craw, g4 = lstm_v1_cuda.lstm_scan_fwd(
        xw, args["mask"], args["w_m"], args["ph"])
    torch.cuda.synchronize()
    for a, b2 in ((m1, m4), (c1, c4)):
        assert torch.equal(a.view(torch.int32), b2.view(torch.int32))
    assert torch.equal(g1.view(torch.int16), g4.view(torch.int16))
    valid = args["mask"][:, :, None].expand_as(c4) > 0
    torch.testing.assert_close(craw[valid], c4[valid], rtol=0, atol=0)


def test_smem_formulas_match_the_library(dev):
    """The host's shared-memory arithmetic (the route choice, the cluster
    plans of kernels 1 and 3, kernel 2's table, the product kernel's
    ring) is the kernels' own."""
    lib = build.load()
    for b, h in ((8, 320), (128, 320), (8, 640), (128, 640), (20, 1024),
                 (3, 32)):
        for bf16 in (True, False):
            p = lstm_cuda.fused_launch(b, 64, h, bf16).fwd
            got = lib.lstm_fwd_smem_bytes(h, p.rows, p.units, p.kres,
                                          int(bf16))
            assert got == lstm_cuda.fwd_smem_bytes(h, p.rows, p.units,
                                                   p.kres, bf16)
            assert got <= lstm_cuda.SMEM_LIMIT
            q = lstm_cuda.fused_launch(b, 64, h, bf16).bwd
            got = lib.lstm_bwd_smem_bytes(*q, int(bf16))
            assert got == lstm_cuda.bwd_smem_bytes(*q, bf16)
            assert got <= lstm_cuda.SMEM_LIMIT
    for h, rb in ((640, 2), (1152, 1), (2632, 2), (5811, 1)):
        assert lib.lstm_scan_fwd_smem_bytes(h, rb) == \
            lstm_v1_cuda.fwd_smem_bytes(h, rb)
        assert lib.lstm_scan_bwd_smem_bytes(h, rb) == \
            lstm_v1_cuda.bwd_smem_bytes(h, rb)
    # kernels 4 and 5's cluster plans: the recurrences' own formulas, at
    # least one cluster resident, and all of them where the host counts
    # one wave (kernel 5's plan at B=128, H=1152: 8 clusters of 8)
    for b in (1, 8, 20, 128):
        for h in (40, 640, 1152, 1600, 1664, 2624):
            p = lstm_v1_cuda.fwd_launch(b, h).plan
            assert lib.lstm_fwd_smem_bytes(h, p.rows, p.units, p.kres, 1) \
                == lstm_cuda.fwd_smem_bytes(h, p.rows, p.units, p.kres, True)
            assert lib.lstm_fwd_max_clusters(b, h, *p, 1) >= 1
            if h > 1664:
                continue
            q = lstm_v1_cuda.bwd_launch(b, h).plan
            assert lib.lstm_bwd_smem_bytes(*q, 1) == \
                lstm_cuda.bwd_smem_bytes(*q, True) <= lstm_cuda.SMEM_LIMIT
            active = lib.lstm_scan_bwd_max_clusters(b, h, *q)
            assert active >= 1
            if lstm_cuda.one_wave(b, q.cluster, q.rows):
                assert active >= -(-b // q.rows), (b, h, q, active)
    for mp, k in ((128, 64), (4096, 512), (16384, 512), (16384, 16384)):
        assert lib.dedup_prune_smem_bytes(mp, k) == \
            beam_cuda.smem_bytes(mp, k)
    # the product kernel's ring of stages, its alignment slack and barriers
    assert lib.gemm_bf16_smem_bytes() == lstm_cuda.GEMM_SMEM_BYTES
    assert lstm_cuda.GEMM_SMEM_BYTES <= lstm_cuda.SMEM_LIMIT


@pytest.mark.parametrize("b,h", [(8, 320), (128, 320), (8, 640), (128, 640)])
def test_lstm_clusters_are_co_resident(dev, b, h):
    """Every cluster of kernel 1's recurrence fits on the card at once at
    the serving and training shapes (no second wave)."""
    p = lstm_cuda.fused_launch(b, 64, h).fwd
    active = build.load().lstm_fwd_max_clusters(b, h, p.cluster, p.rows,
                                                p.units, p.kres, 1)
    assert active >= -(-b // p.rows)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("b,h", [(1, 320), (8, 320), (128, 320), (8, 640),
                                 (20, 640), (128, 640), (8, 1024),
                                 (128, 1024)])
def test_lstm_bwd_plan_is_launchable(dev, b, h, bf16):
    """Kernel 3's cluster plan (host arithmetic) against the library: its
    shared memory is the kernel's own formula, and at least one cluster of
    it is resident (the launch raises otherwise)."""
    lib = build.load()
    q = lstm_cuda.bwd_plan(b, h, bf16)
    assert lib.lstm_bwd_smem_bytes(*q, int(bf16)) == \
        lstm_cuda.bwd_smem_bytes(*q, bf16)
    assert lib.lstm_bwd_max_clusters(b, h, *q, int(bf16)) >= 1


def shape_args(dev, dtype, b, h, t=9, d=48, seed=0):
    """Kernel 1's inputs at width h: row 0 full length, the last row (for
    b > 1) of length 0, the rest in between; weights +-0.1."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.uniform(-0.1, 0.1, s).astype(np.float32)).to(dev)
    lens = rng.integers(1, t + 1, b)
    lens[0] = t
    if b > 1:
        lens[-1] = 0
    mask = (torch.arange(t)[:, None] < torch.from_numpy(lens)[None]).float()
    x = torch.from_numpy(rng.standard_normal((t, b, d)).astype(np.float32))
    return dict(x=x.to(dev, dtype), mask=mask.to(dev),
                w_x=f(d, 4 * h).to(dtype), bias=f(4 * h),
                w_m=f(h, 4 * h).to(dtype), ph=f(3, h))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 8, 20, 128])
@pytest.mark.parametrize("h", [320, 640, 1024])
def test_lstm_kernel_shapes(dev, h, b, dtype):
    """Kernel 1 (projection + cluster recurrence) against its plain version
    at the cluster shapes it takes (8- and 16-CTA clusters, 16 and 32 rows,
    W_m slices wholly and partly resident), state_bf16 on and off, with and
    without residuals: m and c at the bf16 tolerance rtol 2e-2 / atol 2e-3
    (f32 compute and state: 1e-5, sums in another order), the gates at the
    bf16 one."""
    args = shape_args(dev, dtype, b, h)
    for sb in (False, True):
        tol = (1e-5, 1e-5) if dtype == torch.float32 and not sb else \
            (2e-2, 2e-3)
        for res in (False, True):
            before = lstm_cuda.launches
            got = lstm_cuda.lstm_direction(**args, state_bf16=sb,
                                           with_residuals=res)
            want = lstm_cuda.lstm_direction_ref(**args, state_bf16=sb,
                                                with_residuals=res)
            torch.cuda.synchronize()
            assert lstm_cuda.launches == before + 1
            if not res:
                got, want = (got,), (want,)
            for name, g, w, (rtol, atol) in zip(
                    ("m", "c", "gates"), got, want,
                    (tol, tol, (2e-2, 2e-3))):
                assert g.dtype == w.dtype and g.shape == w.shape, name
                torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                           atol=atol, msg=f"{name} sb={sb}")


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def kernel_1_step(args, m, c):
    """Kernel 1's plain step (lstm_direction_ref's arithmetic) at every
    step at once, from the given m and c carries one step back (zero at
    t=0): (m, c, gates) in float32."""
    f32, cdt = torch.float32, args["x"].dtype
    h = args["w_m"].shape[0]
    ph = args["ph"]
    m_prev, c_prev = lstm_v1_cuda._shift(m.float()), lstm_v1_cuda._shift(
        c.float())
    xw = torch.matmul(args["x"].float(), args["w_x"].float()) + args["bias"]
    gifo = xw + torch.matmul(m_prev.to(cdt).to(f32), args["w_m"].float())
    g = torch.tanh(gifo[..., :h])
    i = torch.sigmoid(gifo[..., h:2 * h] + c_prev * ph[0])
    f = torch.sigmoid(gifo[..., 2 * h:3 * h] + c_prev * ph[1])
    c_raw = f * c_prev + i * g
    o = torch.sigmoid(gifo[..., 3 * h:] + c_raw * ph[2])
    mt = args["mask"][:, :, None]
    return (o * torch.tanh(c_raw) * mt + m_prev * (1.0 - mt),
            c_raw * mt + c_prev * (1.0 - mt), torch.cat([g, i, f, o], -1))


@pytest.mark.parametrize("case", [
    # (name, compute dtype, B, T, D, H, residuals)
    ("wsj_train", torch.bfloat16, 128, 768, 640, 320, False),
    ("wsj_train", torch.bfloat16, 128, 768, 640, 320, True),
    ("libri_train", torch.bfloat16, 128, 768, 1280, 640, False),
    ("libri_train", torch.bfloat16, 128, 768, 1280, 640, True),
    ("ragged", torch.bfloat16, 104, 96, 640, 320, True),
    ("one_step", torch.bfloat16, 20, 1, 48, 320, True),
    ("two_steps", torch.bfloat16, 20, 2, 48, 640, True),
    ("rows_16", torch.bfloat16, 16, 96, 120, 320, True),
    ("rows_16", torch.bfloat16, 8, 96, 360, 640, False),
    ("kernel_4", torch.bfloat16, 128, 96, 0, 1152, True),
    ("f32", torch.float32, 20, 96, 48, 320, True),
], ids=lambda c: "-".join(map(str, (c[0], c[2], c[3], c[5],
                                     "res" if c[6] else "m"))))
def test_lstm_recurrence_step_cases(dev, case):
    """Kernel 1's recurrence step (xw and the mask loaded under the
    product, the split cluster barrier, 2 or 3 column tiles a warp by
    shape) against the plain version at the training cells' shapes, a
    ragged batch, the first and the last step of the double buffer, the
    16-row plan, kernel 4 at H=1152 (no W_m row resident) and the f32
    path.

    The step keeps the order of the product and of the gate arithmetic,
    so m, c and the gates are the bits of the one-barrier step it
    replaced (eesen_tpu_torch/tools/lstm_v1_timing.py hashes them at the
    training shapes for two checkouts).  Against the plain version, which
    sums in another order: each step from the kernel's own carries at the
    JAX bf16 tolerance rtol 2e-2 / atol 2e-3 (f32: 1e-5), and the
    free-running m within 1e-2 relative L2.  The state type and the
    residuals change only the stores: m and c under state_bf16 are the
    f32-state run's values rounded, and the gates its bits."""
    name, dtype, b, t, d, h, res = case
    bf16 = dtype == torch.bfloat16
    plan = lstm_cuda.fwd_plan(b, h, bf16)
    assert plan.rows == (16 if b <= 16 else 32) or not bf16
    if name == "kernel_4":
        assert plan.kres == 0
        args, _ = scan_args(dev, h, t=t, b=b, seed=7)
        got = lstm_v1_cuda.lstm_scan_fwd(**args)
        step = scan_step(args, got[0], got[1])
        for what, g, st in zip(("m", "c", "c_raw", "gates"), got, step):
            torch.testing.assert_close(g.float(), st.float(), rtol=2e-2,
                                       atol=2e-3, msg=lambda e: f"{what}: {e}")
        assert rel_l2(got[0], lstm_v1_cuda.lstm_scan_fwd_ref(**args)[0]) \
            <= 1e-2
        return
    args = shape_args(dev, dtype, b, h, t=t, d=d, seed=b + h)
    before = lstm_cuda.launches
    m, c, gates = lstm_cuda.lstm_direction(**args, with_residuals=True)
    torch.cuda.synchronize()
    assert lstm_cuda.launches - before == 1
    tol = (2e-2, 2e-3) if bf16 else (1e-5, 1e-5)
    for what, g, st in zip(("m", "c", "gates"), (m, c, gates),
                           kernel_1_step(args, m, c)):
        torch.testing.assert_close(g.float(), st, rtol=tol[0], atol=tol[1],
                                   msg=lambda e: f"{what}: {e}")
    assert rel_l2(m, lstm_cuda.lstm_direction_ref(**args)) <= 1e-2
    got = lstm_cuda.lstm_direction(**args, state_bf16=True,
                                   with_residuals=res)
    torch.cuda.synchronize()
    want = (m, c, gates) if res else (m,)
    for g, w in zip(got if res else (got,), want):
        w = w.to(torch.bfloat16) if w.dtype == torch.float32 and \
            g.dtype == torch.bfloat16 else w
        assert torch.equal(_bits(g), _bits(w))


def bwd_close(name, got, want, bf16):
    """|got - want| <= atol * max(1, max|want|) + rtol * |want|: a weight
    gradient sums T*B products, so the error of sums in another order
    grows with its largest entry, not with each entry.  f32: rtol 1e-4 /
    atol 1e-5.  bf16: the JAX fused-gradient tolerance, rtol 5e-2 and atol
    5e-3 (2e-2 on dx, unscaled), and 1e-2 relative L2 (chip_smoke.py's
    BWD_W_TOL, BWD_DX_TOL, BWD_REL_L2)."""
    assert got.dtype == want.dtype and got.shape == want.shape, name
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all(), name
    rtol, atol = (5e-2, 5e-3) if bf16 else (1e-4, 1e-5)
    scale = max(1.0, float(w.abs().max()))
    if bf16 and name.startswith("dx"):
        atol, scale = 2e-2, 1.0
    err = (g - w).abs()
    worst = float((err / (atol * scale + rtol * w.abs())).max())
    assert worst <= 1.0, f"{name}: max abs err {float(err.max())}, " \
        f"max|want| {float(w.abs().max())}, {worst} of the tolerance"
    if bf16:
        assert float((g - w).norm() / w.norm().clamp_min(1e-30)) <= 1e-2, \
            name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 8, 20, 128])
@pytest.mark.parametrize("h", [320, 640, 1024])
def test_lstm_bwd_kernel_shapes(dev, h, b, dtype):
    """Kernel 3 (cluster recurrence + products) against its plain version
    at the cluster shapes it takes (8- and 16-CTA clusters, 16 and 32
    rows, W_m slices wholly and partly resident), state_bf16 on and off,
    with a length-0 row (b > 1), on kernel 1's residuals."""
    args = shape_args(dev, dtype, b, h, seed=h + b)
    gm = torch.from_numpy(np.random.default_rng(b).standard_normal(
        (9, b, h)).astype(np.float32)).to(dev)
    for sb in (False, True):
        m, c, gates = lstm_cuda.lstm_direction(**args, state_bf16=sb,
                                               with_residuals=True)
        inp = dict(x=args["x"], mask=args["mask"], gates=gates, c=c, m=m,
                   gm=gm.to(m.dtype), w_x=args["w_x"], w_m=args["w_m"],
                   ph=args["ph"])
        before = lstm_cuda.bwd_launches
        got = lstm_cuda.lstm_direction_bwd(**inp)
        want = lstm_cuda.lstm_direction_bwd_ref(**inp)
        torch.cuda.synchronize()
        assert lstm_cuda.bwd_launches == before + 1
        for name, g, w in zip(("dx", "dw_x", "dw_m", "db", "dph"), got,
                              want):
            bwd_close(f"{name} sb={sb}", g, w, dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype,b,h", [(torch.bfloat16, 128, 640),
                                       (torch.bfloat16, 8, 320),
                                       (torch.float32, 20, 1024)])
def test_lstm_bwd_kernel_is_deterministic(dev, dtype, b, h):
    """The cluster sums its partials in a fixed order and uses no float
    atomics: two runs on the same inputs give the same bits."""
    args = shape_args(dev, dtype, b, h, t=17, seed=5)
    m, c, gates = lstm_cuda.lstm_direction(**args, state_bf16=True,
                                           with_residuals=True)
    gm = torch.from_numpy(np.random.default_rng(6).standard_normal(
        m.shape).astype(np.float32)).to(dev, m.dtype)
    inp = dict(x=args["x"], mask=args["mask"], gates=gates, c=c, m=m, gm=gm,
               w_x=args["w_x"], w_m=args["w_m"], ph=args["ph"])
    first = [g.clone() for g in lstm_cuda.lstm_direction_bwd(**inp)]
    second = lstm_cuda.lstm_direction_bwd(**inp)
    torch.cuda.synchronize()
    for a, b2 in zip(first, second):
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b2.view(torch.int16 if b2.dtype == torch.bfloat16
                                   else torch.int32))


@pytest.mark.parametrize("d,h", [(44, 36), (45, 37), (1, 5)])
@pytest.mark.parametrize("b", [3, 20])
def test_lstm_kernels_at_widths_the_tensor_maps_refuse(dev, d, h, b):
    """bf16 kernels 1 and 3 where a product operand's rows are not whole
    16-byte units (D or 4H not a multiple of 8, H not one for m) or m is
    f32 (state_bf16 off): the zero-padded copies and the cast, against the
    plain versions at the tolerances of test_lstm_kernel_shapes and
    bwd_close."""
    args = shape_args(dev, torch.bfloat16, b, h, d=d, seed=d + h)
    gm = torch.from_numpy(np.random.default_rng(h).standard_normal(
        (9, b, h)).astype(np.float32)).to(dev)
    for sb in (False, True):
        got = lstm_cuda.lstm_direction(**args, state_bf16=sb,
                                       with_residuals=True)
        want = lstm_cuda.lstm_direction_ref(**args, state_bf16=sb,
                                            with_residuals=True)
        for name, g, w in zip(("m", "c", "gates"), got, want):
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=2e-3, msg=f"{name} sb={sb}")
        m, c, gates = got
        inp = dict(x=args["x"], mask=args["mask"], gates=gates, c=c, m=m,
                   gm=gm.to(m.dtype), w_x=args["w_x"], w_m=args["w_m"],
                   ph=args["ph"])
        for name, g, w in zip(("dx", "dw_x", "dw_m", "db", "dph"),
                              lstm_cuda.lstm_direction_bwd(**inp),
                              lstm_cuda.lstm_direction_bwd_ref(**inp)):
            bwd_close(f"{name} sb={sb}", g, w, True)


def product_close(name, got, want):
    """|got - want| <= 1e-3 * max(1, max|want|) + 1e-2 * |want|: bf16
    operands with float32 sums against torch.matmul of their float32
    copies, a sum in another order (and, for a bf16 C, one rounding)."""
    assert got.shape == want.shape, name
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all(), name
    err = (g - w).abs()
    scale = max(1.0, float(w.abs().max()))
    worst = float((err / (1e-3 * scale + 1e-2 * w.abs())).max())
    assert worst <= 1.0, f"{name}: max abs err {float(err.max())}, " \
        f"{worst} of the tolerance"


# (M, N, K, b_k0, bias, C dtype, splits): ragged M, N and K, K below one
# k step, a start row in B (dW_m's), bias, a bf16 C and k-splits
GEMM_CASES = [
    (200, 136, 200, 0, False, torch.float32, 1),
    (200, 136, 200, 0, True, torch.float32, 1),
    (200, 136, 200, 0, False, torch.bfloat16, 1),
    (72, 264, 1000, 24, False, torch.float32, 3),
    (72, 264, 1000, 0, True, torch.float32, 2),
    (8, 8, 8, 8, False, torch.float32, 1),
    (264, 72, 40, 0, True, torch.bfloat16, 1),
]


@pytest.mark.parametrize("a_mn,b_mn", [(False, True), (True, True),
                                       (False, False), (True, False)])
@pytest.mark.parametrize("case", GEMM_CASES)
def test_gemm_bf16_matches_matmul(dev, a_mn, b_mn, case):
    """The product kernel alone in all four operand layouts (kernel 1's
    projection: A k-contiguous, B n-contiguous; dW_x and dW_m: A
    m-contiguous; dx: both k-contiguous) against torch.matmul of the
    operands' float32 copies, per k-slice (`product_close`)."""
    m, n, k, k0, with_bias, out_dtype, splits = case
    rng = np.random.default_rng(m + n + k)
    f = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(
        np.float32)).to(dev)
    a = f(*((k, m) if a_mn else (m, k))).to(torch.bfloat16)
    b = f(*((k0 + k, n) if b_mn else (n, k0 + k))).to(torch.bfloat16)
    bias = f(n) if with_bias else None
    kw = dict(a_mn=a_mn, b_mn=b_mn, b_k0=k0, bias=bias, out_dtype=out_dtype,
              splits=splits)
    got = lstm_cuda.gemm_bf16(a, b, **kw)
    av = (a.t() if a_mn else a).float()
    bv = (b[k0:] if b_mn else b[:, k0:].t()).float()
    ks = build.load().gemm_bf16_kslice(k, splits)
    want = torch.stack([av[:, z * ks:(z + 1) * ks] @ bv[z * ks:(z + 1) * ks]
                        for z in range(splits)])
    if bias is not None:
        want = want + bias
    torch.cuda.synchronize()
    assert got.dtype == out_dtype
    product_close(f"{case}", got, want if splits > 1 else want[0])
    cpu = lstm_cuda.gemm_bf16(a.cpu(), b.cpu(), **{
        **kw, "bias": bias.cpu() if bias is not None else None})
    product_close(f"{case} cpu", cpu, want.cpu() if splits > 1
                  else want[0].cpu())


def test_gemm_bf16_at_librispeech(dev):
    """Kernel 3's dW_x at the LibriSpeech training shape (D=1280, H=640,
    T*B=98,304, gemm_plan's split, summed in order) and kernel 1's
    projection with its bias, against torch.matmul of float32 copies."""
    tb, d, g = 98304, 1280, 2560
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((tb, d), generator=gen, device=dev).sub_(0.5).bfloat16()
    dg = torch.rand((tb, g), generator=gen, device=dev).sub_(0.5).bfloat16()
    plan = lstm_cuda.gemm_plan(d, g, tb)
    got = lstm_cuda.gemm_bf16(x, dg, a_mn=True, splits=plan.splits)
    want = x.float().t() @ dg.float()
    product_close("dW_x", got.sum(0), want)
    w = dg[:d].contiguous()
    bias = torch.rand(g, generator=gen, device=dev)
    got = lstm_cuda.gemm_bf16(x[:4096].contiguous(), w, bias=bias)
    product_close("projection", got, x[:4096].float() @ w.float() + bias)


def test_gemm_plan_matches_the_library(dev):
    """gemm_plan's k per slice is the kernel's (gemm_bf16_kslice), at the
    training shapes and ragged ones."""
    lib = build.load()
    for m, n, k in ((1280, 2560, 98304), (640, 2560, 98176),
                    (120, 1280, 98304), (320, 1280, 98176), (44, 144, 33),
                    (200, 300, 1000)):
        p = lstm_cuda.gemm_plan(m, n, k)
        assert lib.gemm_bf16_kslice(k, p.splits) == p.kslice


def test_direction_above_1024_takes_the_v1_route(dev):
    """H=1152: the fused kernels refuse the shape (a direct call raises),
    `_direction_scan` runs kernels 4 and 5 instead and matches the CPU
    plain run (m at rtol 2e-2 / atol 2e-3, gradients within 1e-2
    relative L2)."""
    h, d, t, b = 1152, 96, 12, 3
    cfg = tbilstm.BiLstmConfig(input_dim=d, cell_dim=h)
    p = tbilstm.init_bilstm_layer(torch.Generator().manual_seed(0), cfg,
                                  "cpu")["fw"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (t, b, d)).astype(np.float32))
    mask = (torch.arange(t)[:, None] < torch.tensor([t, 7, 0])).float()
    with pytest.raises(ValueError, match="v1 route"):
        lstm_cuda.lstm_direction(
            x.to(dev, torch.bfloat16), mask.to(dev),
            p["w_gifo_x"].reshape(d, 4 * h).to(dev),
            p["bias"].reshape(-1).to(dev),
            p["w_gifo_m"].reshape(h, 4 * h).to(dev),
            torch.stack([p[k] for k in ("phole_i_c", "phole_f_c",
                                        "phole_o_c")]).to(dev))
    out = {}
    for where in (dev, torch.device("cpu")):
        pp = {k: v.to(where).requires_grad_() for k, v in p.items()}
        before = (lstm_cuda.launches, lstm_v1_cuda.launches,
                  lstm_v1_cuda.bwd_launches)
        m = tbilstm._direction_scan(pp, x.to(where), mask.to(where), cfg)
        grads = torch.autograd.grad(m.float().sum(), list(pp.values()))
        launched = (lstm_cuda.launches - before[0],
                    lstm_v1_cuda.launches - before[1],
                    lstm_v1_cuda.bwd_launches - before[2])
        out[where.type] = (m.float().cpu(), [g.cpu() for g in grads],
                           launched)
    assert out["cuda"][2] == (0, 1, 1) and out["cpu"][2] == (0, 0, 0)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=2e-2,
                               atol=2e-3)
    for g, c in zip(out["cuda"][1], out["cpu"][1]):
        assert float((g - c).norm() / c.norm().clamp_min(1e-30)) < 1e-2


def ctc_inputs(dev, b=6, t=40, v=9, l=8, seed=0):
    """Six rows: full length, shorter, a short row, a length-0 row (frames
    and labels), a row without labels and a one-frame row."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.standard_normal((b, t, v)).astype(
        np.float32))
    ll = torch.tensor([t, t - 5, 20, 0, t - 1, 1][:b])
    lab_l = torch.tensor([l, l - 2, 5, 0, 0, 1][:b])
    labels = torch.from_numpy(rng.integers(1, v, (b, l)))
    labels[0, 1] = labels[0, 0]                          # a repeat
    _, _, can_skip, _, lp_e = _ctc_prep(logits, labels, lab_l, 0)
    _, _, init = _final_states(lab_l, lp_e.shape[2])
    skip = torch.where(can_skip, 0.0, LOG_ZERO)
    return [x.to(dev).contiguous() for x in (lp_e, skip, init, ll)]


def check_ctc(inp, pad=3):
    """Kernels 6 and 7 against their plain versions: LOG_ZERO positions
    identical; elsewhere float32 log-space sums, rtol 1e-5 / atol 1e-4.
    Row `pad` has length 0."""
    before = (ctc_cuda.alpha_launches, ctc_cuda.beta_launches)
    got = ctc_cuda.ctc_alpha_beta(*inp)
    want = ctc_cuda.ctc_alpha_beta_ref(*inp)
    torch.cuda.synchronize()
    assert (ctc_cuda.alpha_launches, ctc_cuda.beta_launches) == (
        before[0] + 1, before[1] + 1)
    for g, w in zip(got, want):
        fin = w > LOG_ZERO_THRESHOLD
        assert torch.equal(g > LOG_ZERO_THRESHOLD, fin)
        torch.testing.assert_close(g[fin], w[fin], rtol=1e-5, atol=1e-4)
    # the padded row: alpha is the t=0 init row, beta all LOG_ZERO
    assert torch.equal(got[0][pad], got[0][pad, :1].expand_as(got[0][pad]))
    assert torch.all(got[1][pad] == LOG_ZERO)
    return got


def ring_inputs(dev, b, t, s, lens, seed):
    """Kernel inputs at any S = 2L+1 without the prep: negative
    log-probabilities, a random skip mask (never into a blank or s < 2),
    each row's final states from L labels, and the given frame counts."""
    rng = np.random.default_rng(seed)
    lp = -rng.exponential(2.0, (b, t, s)).astype(np.float32)
    skip = np.where(rng.random((b, s)) < 0.6, 0.0, LOG_ZERO).astype(
        np.float32)
    skip[:, :2] = LOG_ZERO
    skip[:, 0::2] = LOG_ZERO              # blanks are never skipped into
    _, _, init = _final_states(torch.full((b,), (s - 1) // 2), s)
    return [torch.from_numpy(lp).to(dev), torch.from_numpy(skip).to(dev),
            init.to(dev).contiguous(),
            torch.tensor(lens, dtype=torch.int32, device=dev)]


def test_ctc_kernels_match_plain(dev):
    check_ctc(ctc_inputs(dev))


@pytest.mark.parametrize("l,t", [(600, 1300), (2000, 4200)])
def test_ctc_kernels_past_1024_states(dev, l, t):
    """S = 2L+1 = 1201 and 4001 states (a thread owns 2 and 4; the two
    shared rows of S=4001 need more than 48 KB): mixed frame and label
    lengths, a length-0 row; the full row reaches its last states."""
    inp = ctc_inputs(dev, t=t, l=l, seed=l)
    assert inp[0].shape[2] == 2 * l + 1
    alpha, _ = check_ctc(inp)
    assert bool((alpha[0, t - 1, 2 * l - 1:] > LOG_ZERO_THRESHOLD).all())


@pytest.mark.parametrize("s", [1, 3, 201, 1201, 4001])
def test_ctc_kernels_around_the_ring_depth(dev, s):
    """T at 1, 2 and around the ring's depth P (P-1, P, P+1): a full row,
    a length-0 row, a one-frame row and rows shorter than P."""
    p = ctc_cuda.ctc_plan(s).depth
    for t in sorted({1, 2, p - 1, p, p + 1} - {0}):
        lens = [t, 0, 1, max(t - 1, 0), min(p - 1, t), min(2, t)]
        check_ctc(ring_inputs(dev, 6, t, s, lens, seed=s + t), pad=1)


@pytest.mark.parametrize("s", [1, 1201, 4001, 5810, 8192, 9684, 14527,
                               14528, 29054])
def test_ctc_kernels_at_every_instance(dev, s):
    """One S for each (states a thread, ring depth) instance the library
    dispatches, up to the largest accepted S (29054: 32 states a thread,
    no ring); the first S past it is refused with a CUDA error, as the
    rows alone no longer fit."""
    check_ctc(ring_inputs(dev, 3, 5, s, [5, 0, 3], seed=s), pad=1)
    if s == 29054:
        bad = ring_inputs(dev, 1, 2, s + 1, [2], seed=0)
        with pytest.raises(RuntimeError):
            ctc_cuda.ctc_alpha_beta(*bad)


def test_ctc_plan_matches_the_library(dev):
    """ctc_cuda.ctc_plan's depth and shared memory are the library's
    ctc_depth / ctc_smem_bytes, across every S the kernels take and
    past them."""
    lib = build.load()
    for s in [*range(1, 30100, 53), 5810, 5811, 9684, 9685, 14527, 14528,
              29054, 29055, 32768, 32769]:
        plan = ctc_cuda.ctc_plan(s)
        assert lib.ctc_depth(s) == (plan.depth if plan else 0), s
        if plan:
            assert lib.ctc_smem_bytes(s, plan.depth) == plan.smem_bytes
        for depth in (1, 2, 4, 8):
            assert lib.ctc_smem_bytes(s, depth) == \
                ctc_cuda.smem_bytes(s, depth)


def test_ctc_kernels_are_deterministic(dev):
    """Two runs give equal bits (no atomics; each state's sums in one
    order)."""
    for l, t in ((8, 40), (600, 1300)):
        inp = ctc_inputs(dev, t=t, l=l, seed=l)
        one = ctc_cuda.ctc_alpha_beta(*inp)
        two = ctc_cuda.ctc_alpha_beta(*inp)
        for a, b in zip(one, two):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("m,k", [(100, 64), (4096, 512), (14336, 512),
                                 (8192, 5000), (13192, 5000)])
def test_dedup_kernel_equals_plain(dev, m, k):
    rng = np.random.default_rng(m)
    dst = rng.integers(0, max(m // 3, 2), (8, m)).astype(np.int32)
    score = (rng.standard_normal((8, m)) * 4.0).astype(np.float32)
    score[rng.random((8, m)) < 0.2] = np.inf
    dst_t = torch.from_numpy(dst).to(dev)
    score_t = torch.from_numpy(score).to(dev)
    got = beam_cuda.dedup_prune(dst_t, score_t, k, 6.0)
    want = beam_cuda.dedup_prune_ref(dst_t, score_t, k, 6.0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m,k", [
    (128, 64), (128, 128), (4096, 64), (4096, 512), (4096, 4096),
    (14336, 64), (14336, 512), (14336, 16384), (16384, 512), (16384, 16384),
    (8192, 5000), (13192, 5000),
])
def test_dedup_kernel_adversarial(dev, m, k):
    """The cluster kernel equals its plain version bit for bit on every
    adversarial case (-0.0/+0.0, negative scores, ties, every lane dead,
    one dst, fewer live lanes than K, K = Mp, int32-extreme dst, NaN
    scores), with launches counted."""
    for case in CASES:
        dst, score = make_case(case, 8, m, seed=m + k)
        dst_t = torch.from_numpy(dst).to(dev)
        score_t = torch.from_numpy(score).to(dev)
        before = beam_cuda.launches
        got = beam_cuda.dedup_prune(dst_t, score_t, k, 6.0)
        want = beam_cuda.dedup_prune_ref(dst_t, score_t, k, 6.0)
        torch.cuda.synchronize()
        assert beam_cuda.launches == before + 1
        for name, g, w in zip(("states", "scores", "kept"), got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w), f"{case}: {name}"
            if name == "scores":      # -0.0 is never written
                assert torch.equal(torch.signbit(g), torch.signbit(w)), case


@pytest.mark.parametrize("m", [100, 4096, 16384])
def test_dedup_kernel_nan_rows(dev, m):
    """A NaN score makes the row minimum NaN, as torch.min does: the whole
    row comes out dead (state -1, score +inf, kept in lane order), bit for
    bit as dedup_prune_ref, on rows that are all NaN and rows with one
    NaN among finite scores."""
    dst, score = make_case("nan", 8, m, seed=m)
    dst_t = torch.from_numpy(dst).to(dev)
    score_t = torch.from_numpy(score).to(dev)
    got = beam_cuda.dedup_prune(dst_t, score_t, 64, 6.0)
    want = beam_cuda.dedup_prune_ref(dst_t, score_t, 64, 6.0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.all(got[0] == -1) and torch.all(torch.isinf(got[1]))
    assert torch.equal(got[2][0], torch.arange(64, device=dev,
                                               dtype=torch.int32))


def test_dedup_kernel_refuses_wide_rows(dev):
    z = torch.zeros((1, beam_cuda.MAX_LANES + 1), device=dev)
    with pytest.raises(ValueError):
        beam_cuda.dedup_prune(z.int(), z, 8, 1.0)


def small_graph(hub_threshold=0):
    scfg = SynthConfig(num_phones=5, num_words=20)
    rng = np.random.default_rng(1)
    lex = make_lexicon(scfg, rng)
    vocab = [w for w, _ in lex]
    sents = [[vocab[int(j)] for j in rng.integers(0, 20, 4)]
             for _ in range(40)]
    lang = compile_lang(lex, [f"p{i:02d}" for i in range(5)])
    g = compile_graph(build_tlg(lang.t_fst, build_lg(
        lang.l_fst, arpa_to_fst(estimate_bigram_arpa(sents, vocab=vocab),
                                lang.words))), max_degree=4,
        hub_threshold=hub_threshold, build_closure=True)
    return g, rng


def test_decoder_on_card_matches_cpu(dev):
    g, rng = small_graph()
    ll = rng.standard_normal((3, 20, 6)).astype(np.float32) * 3.0
    ll -= np.log(np.exp(ll).sum(-1, keepdims=True))
    lens = np.array([20, 15, 9])
    dec = tbeam.make_beam_decoder(g, tbeam.BeamSearchConfig(
        beam=12.0, max_active=32))
    before = beam_cuda.launches
    out_d = dec(ll, lens, tbeam.DeviceGraph.put(g, device=dev))
    assert beam_cuda.launches > before
    out_c = dec(ll, lens, tbeam.DeviceGraph.put(g, device="cpu"))
    res_d = tbeam.traceback(out_d, lens, g.final_weight)
    res_c = tbeam.traceback(out_c, lens, g.final_weight)
    for (w_d, c_d), (w_c, c_c) in zip(res_d, res_c):
        assert w_d == w_c
        np.testing.assert_allclose(c_d, c_c, rtol=1e-5)


def _same_results(got, want, rtol=1e-5):
    for (w_g, c_g), (w_w, c_w) in zip(got, want):
        assert w_g == w_w
        np.testing.assert_allclose(c_g, c_w, rtol=rtol)


def test_budgeted_k5000_decode_takes_kernel_2(dev, monkeypatch):
    """max_active 5000 on the packed layout: unbudgeted, the 20,000-lane
    emit merge and the 25,000-lane closure merge take the sort route;
    with budgets of 5000 and 11,000 lanes both merges (5000 and 16,000
    lanes) take kernel 2,
    one launch a merge, with overflow 0 and the same words and costs."""
    monkeypatch.setattr(tbeam, "DENSE_ROWS_BUDGET", 0)
    g, rng = small_graph()
    ll = rng.standard_normal((3, 20, 6)).astype(np.float32) * 3.0
    ll -= np.log(np.exp(ll).sum(-1, keepdims=True))
    lens = np.array([20, 15, 9])
    dg = tbeam.DeviceGraph.put(g, device=dev)
    base = dict(beam=17.0, max_active=5000, acoustic_scale=0.9)
    before = beam_cuda.launches
    out0 = tbeam.make_beam_decoder(g, tbeam.BeamSearchConfig(**base))(
        ll, lens, dg)
    assert beam_cuda.launches == before
    before = beam_cuda.launches
    out1 = tbeam.make_beam_decoder(g, tbeam.BeamSearchConfig(
        **base, arc_budget_emit=5000, arc_budget_x=11000))(ll, lens, dg)
    assert beam_cuda.launches - before == 1 + 2 * 20
    assert int(out1.overflow.sum()) == 0
    _same_results(tbeam.traceback(out1, lens, g.final_weight),
                  tbeam.traceback(out0, lens, g.final_weight))


def test_hub_decode_on_card_takes_kernel_2(dev):
    """A hub graph's widened emit merge on kernel 2: the CPU's words and
    costs."""
    g, rng = small_graph(hub_threshold=4)
    assert g.has_hubs
    ll = rng.standard_normal((3, 20, 6)).astype(np.float32) * 3.0
    ll -= np.log(np.exp(ll).sum(-1, keepdims=True))
    lens = np.array([20, 15, 9])
    dec = tbeam.make_beam_decoder(g, tbeam.BeamSearchConfig(
        beam=12.0, max_active=32))
    before = beam_cuda.launches
    out_d = dec(ll, lens, tbeam.DeviceGraph.put(g, device=dev))
    assert beam_cuda.launches - before == 1 + 2 * 20
    out_c = dec(ll, lens, tbeam.DeviceGraph.put(g, device="cpu"))
    _same_results(tbeam.traceback(out_d, lens, g.final_weight),
                  tbeam.traceback(out_c, lens, g.final_weight))


def test_bilstm_layer_on_card_is_the_time_major_layer(dev):
    """bilstm_layer [B, T, D] on the card: bilstm_layer_tm's bits,
    transposed, with one kernel 1 launch a direction."""
    cfg = tbilstm.BiLstmConfig(input_dim=120, cell_dim=320)
    params = tbilstm.init_bilstm_layer(torch.Generator().manual_seed(0),
                                       cfg, dev)
    x = torch.randn((8, 64, 120), generator=torch.Generator().manual_seed(1)
                    ).to(dev)
    lens = torch.tensor([64, 60, 51, 40, 33, 20, 9, 1])
    before = lstm_cuda.launches
    y = tbilstm.bilstm_layer(params, x, lens, cfg)
    assert lstm_cuda.launches - before == 2
    want = tbilstm.bilstm_layer_tm(params, x.transpose(0, 1).contiguous(),
                                   lens, cfg)
    assert torch.equal(y, want.transpose(0, 1))


def blank_runs(rng, b, t, v):
    """Spikes between blank runs of 1-8 frames, log-normalized."""
    ll = rng.standard_normal((b, t, v)).astype(np.float32) * 0.4
    for i in range(b):
        pos = 0
        while pos < t:
            ll[i, pos, int(rng.integers(1, v))] += 7.0
            run = int(rng.integers(1, 9))
            ll[i, pos + 1:pos + 1 + run, 0] += 12.0
            pos += 1 + run
    return ll - np.log(np.exp(ll).sum(-1, keepdims=True))


@pytest.mark.parametrize("min_run", [1, 3])
def test_compaction_on_card_matches_cpu(dev, min_run):
    """Kept counts, bucket and time_map exact; the merged columns within
    1e-3 (cumsum differences of ~10^3 at T=512, another summation order)."""
    rng = np.random.default_rng(min_run)
    ll = blank_runs(rng, 8, 512, 72)
    lens = np.array([512, 497, 463, 430, 388, 341, 290, 0])
    got = compact_blank_frames(torch.from_numpy(ll).to(dev), lens, 0.98,
                               min_run=min_run)
    want = compact_blank_frames(ll, lens, 0.98, min_run=min_run)
    assert got.loglikes.is_cuda
    assert torch.equal(got.lengths.cpu(), want.lengths)
    assert got.loglikes.shape == want.loglikes.shape
    for i, n in enumerate(want.lengths.tolist()):
        assert torch.equal(got.time_map[i, :n].cpu(), want.time_map[i, :n])
        torch.testing.assert_close(got.loglikes[i, :n].cpu(),
                                   want.loglikes[i, :n], rtol=0, atol=1e-3)


@pytest.mark.parametrize("blank_skip", [0.0, 0.9])
def test_streaming_decoder_on_card_matches_one_shot(dev, blank_skip):
    """StreamingBeamDecoder over 7-frame chunks on the card, kernel 2
    launched: without blank-skip the one-shot decode's words and costs
    (the same frame step, so 1e-5 relative); with it (per-chunk
    compaction) the same chunks streamed on the CPU."""
    g, rng = small_graph()
    ll = blank_runs(rng, 3, 30, 6)
    lens = np.array([30, 22, 9])
    cfg = tbeam.BeamSearchConfig(beam=12.0, max_active=32,
                                 blank_skip=blank_skip, blank_skip_bucket=1)
    act = np.arange(30)[None, :] < lens[:, None]

    def stream(device):
        dec = tbeam.StreamingBeamDecoder(g, cfg, device=device)
        st = dec.start(3)
        for t0 in range(0, 30, 7):
            st = dec.accept(st, ll[:, t0:t0 + 7], act[:, t0:t0 + 7])
        return st["tframes"], dec.finish(st)

    before = beam_cuda.launches
    frames, res = stream(dev)
    assert beam_cuda.launches > before
    if blank_skip:
        want_frames, want = stream("cpu")
        assert frames == want_frames < 30
    else:
        dg = tbeam.DeviceGraph.put(g, device=dev)
        want = tbeam.traceback(tbeam.make_beam_decoder(g, cfg)(ll, lens, dg),
                               lens, g.final_weight)
    for (w, c), (w_r, c_r) in zip(res, want):
        assert w == w_r
        np.testing.assert_allclose(c, c_r, rtol=1e-5)


def test_carried_scan_on_card_launches_no_kernel(dev):
    """A carried call runs the torch-op scan on the card: no LSTM kernel,
    and the CPU's values (f32 compute: 1e-5)."""
    cfg = tbilstm.BiLstmConfig(input_dim=24, cell_dim=32,
                               bidirectional=False,
                               compute_dtype=torch.float32)
    p = tbilstm.init_bilstm_layer(torch.Generator().manual_seed(0), cfg,
                                  device="cpu")["fw"]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((13, 3, 24)).astype(np.float32))
    mask = (torch.arange(13)[:, None] < torch.tensor([13, 9, 0])).float()
    carry = (torch.full((3, 32), 0.1), torch.full((3, 32), -0.2))
    before = (lstm_cuda.launches, lstm_v1_cuda.launches)
    m_d, (c_d, mc_d) = tbilstm._direction_scan(
        {k: v.to(dev) for k, v in p.items()}, x.to(dev), mask.to(dev), cfg,
        carry_in=tuple(v.to(dev) for v in carry), return_carry=True)
    torch.cuda.synchronize()
    assert (lstm_cuda.launches, lstm_v1_cuda.launches) == before
    m_c, (c_c, mc_c) = tbilstm._direction_scan(
        p, x, mask, cfg, carry_in=carry, return_carry=True)
    for got, want in ((m_d, m_c), (c_d, c_c), (mc_d, mc_c)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# the front end and the recipe driver: card against CPU at the JAX
# package's numpy-oracle tolerance (tests/test_features.py:79), where the
# mel power is above a floor (the log of near-silence is FFT rounding)
FE_TOL, FE_MEL_FLOOR = 1e-3, 1.0


def fe_waves(b=4, n=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (rng.standard_normal((b, n)) * 300 + 3000 * np.sin(
        2 * np.pi * rng.uniform(100, 3000, (b, 1)) * t)).astype(np.float32)


@pytest.mark.parametrize("shift,warp", [(10.0, 1.0), (8.0, 0.8), (8.0, 1.2),
                                        (11.0, 0.8), (11.0, 1.2)])
def test_fbank_on_card_matches_cpu(dev, shift, warp):
    """The wsj_phn fbank (40 bins, povey, no dither) and the augmentation
    views' frame shifts and warps, batched, card against CPU; TF32 off."""
    from eesen_tpu_torch.frontend import features as tf

    assert not torch.backends.cuda.matmul.allow_tf32
    opts = tf.FbankOptions(
        frame_opts=tf.FrameOptions(dither=0.0, frame_shift_ms=shift),
        mel_opts=tf.MelOptions(num_bins=40))
    w = torch.from_numpy(fe_waves())
    got = tf.fbank(w.to(dev), opts, vtln_warp=warp)
    assert got.device.type == "cuda"
    want = tf.fbank(w, opts, vtln_warp=warp)
    power = tf.mel_energies(tf.frame_signal(w, opts.frame_opts),
                            opts.mel_opts, opts.frame_opts, warp)
    mask = power > FE_MEL_FLOOR
    assert mask.float().mean() > 0.9
    torch.testing.assert_close(got.cpu()[mask], want[mask], rtol=FE_TOL,
                               atol=FE_TOL)


@pytest.mark.parametrize("name,tol_pitch,tol_nccf", [
    ("tone220", 1e-4, 1e-4), ("vibrato", 1e-4, 1e-4), ("noise", 1e-4, 1e-4),
    ("speechish", 6e-3, 2e-3), ("tone_8k", 1e-4, 1e-4)])
def test_pitch_on_card_matches_golden(dev, name, tol_pitch, tol_nccf):
    """kaldi_pitch on the card against the reference extractor's goldens
    at tests/test_pitch.py's per-case tolerances."""
    import os

    from eesen_tpu_torch.frontend import pitch as tp

    data = np.load(os.path.join(os.path.dirname(__file__), "data",
                                "pitch_golden", "golden.npz"))
    wave = torch.from_numpy(data[f"{name}_wave"]).to(dev)
    got = tp.kaldi_pitch(wave, tp.PitchOptions(
        samp_freq=float(data[f"{name}_sr"])))
    assert got.device.type == "cuda"
    got, gold = got.cpu().numpy(), data[f"{name}_raw"]
    assert got.shape == gold.shape
    assert (np.abs(got[:, 1] - gold[:, 1]) / gold[:, 1]).max() <= tol_pitch
    assert np.abs(got[:, 0] - gold[:, 0]).max() <= tol_nccf


def _card_and_cpu_recipes(dev, tmp_path, **decode):
    """RecipeRun on a small synthetic corpus on the card and on the CPU
    (f32 compute and f32 state), features on each side, the same
    parameters (output affine x20) in both: (runs by device type,
    features by device type, cfg)."""
    import dataclasses

    from eesen_tpu_torch.decoder.beam import BeamSearchConfig
    from eesen_tpu_torch.io.datadir import DataDir
    from eesen_tpu_torch.models.model import AcousticModelConfig, init_model
    from eesen_tpu_torch.recipes import run as trun
    from eesen_tpu_torch.recipes.config import RECIPES
    from eesen_tpu_torch.recipes.synth_corpus import (
        generate_corpus, make_phones,
    )

    scfg = SynthConfig(num_phones=8, num_words=30, num_speakers=3,
                       min_utt_words=2, max_utt_words=4)
    rng = np.random.default_rng(0)
    phones = make_phones(scfg, rng)
    lex = make_lexicon(scfg, rng)
    waves, text, utt2spk = generate_corpus(scfg, 6, 1, lex, phones)
    units = [f"p{i:02d}" for i in range(scfg.num_phones)]
    data = DataDir.write(str(tmp_path / "data"), text=text, utt2spk=utt2spk)
    data.wav_scp = waves
    cfg = dataclasses.replace(
        RECIPES["wsj_phn"],
        model=AcousticModelConfig(input_dim=120, cell_dim=32, num_layers=2,
                                  num_targets=-1,
                                  compute_dtype=torch.float32,
                                  state_bf16=False),
        decode=BeamSearchConfig(beam=14.0, max_active=256,
                                acoustic_scale=0.9, blank_skip=0.98,
                                **decode))
    runs = {d.type: trun.RecipeRun(cfg, str(tmp_path / d.type), lex, units,
                                   device=d)
            for d in (dev, torch.device("cpu"))}
    feats = {}
    for d, run in runs.items():
        run.build_lang()
        feats[d] = run.compute_features(data, dither_seed=None)
        run.build_graph(estimate_bigram_arpa(list(text.values())))
    mcfg = dataclasses.replace(cfg.model, num_targets=len(units) + 1)
    params = init_model(torch.Generator().manual_seed(0), mcfg, "cpu")
    params["out"]["w"] = params["out"]["w"] * 20.0
    log_priors = np.full(len(units) + 1, -np.log(len(units) + 1), np.float32)
    for d, run in runs.items():
        run.params = {"layers": [{k: {n: p.to(d) for n, p in v.items()}
                                  for k, v in layer.items()}
                                 for layer in params["layers"]],
                      "out": {n: p.to(d) for n, p in params["out"].items()}}
        run.model_cfg, run.log_priors = mcfg, log_priors
    return runs, feats, text


def test_recipe_decode_on_card_matches_cpu(dev, tmp_path):
    """RecipeRun on a small synthetic corpus: features on the card
    within FE_TOL of the CPU's (no dither), then the same parameters
    decode on the card (kernels 1 and 2) and on the CPU: the same words,
    costs within 1e-4 relative (f32 compute and f32 state: with
    state_bf16 kernel 1 rounds m to bf16, which the CPU path never does,
    and the costs move by ~1e-3)."""
    runs, feats, _ = _card_and_cpu_recipes(dev, tmp_path)
    for k, v in feats["cpu"].items():
        np.testing.assert_allclose(feats["cuda"][k], v, rtol=FE_TOL,
                                   atol=FE_TOL)
    res = {}
    for d, run in runs.items():
        before = (lstm_cuda.launches, beam_cuda.launches)
        out = {}
        for chunk, _, lens, o in run._run_search(
                feats["cpu"], sorted(feats["cpu"]), run.cfg.decode, 8):
            for key, r in zip(chunk, tbeam.traceback(
                    o, lens, run.graph.final_weight)):
                out[key] = r
        res[d] = out
        if d == "cuda":
            assert lstm_cuda.launches == before[0] + 4
            assert beam_cuda.launches > before[1]
    assert sum(len(w) for w, _ in res["cpu"].values()) > 0
    for key, (words, cost) in res["cpu"].items():
        assert res["cuda"][key][0] == words, key
        np.testing.assert_allclose(res["cuda"][key][1], cost, rtol=1e-4)


def test_recipe_lattices_on_card_match_cpu(dev, tmp_path):
    """decode_lattices and score_sweep on the card (kernels 1 and 2 in
    the search, the lattices on the host) against the CPU, from the CPU's
    features and the same parameters at f32 with state_bf16 off: at each
    acwt the same best-path words, costs within 1e-4 relative, the same
    WERs; at the decode's acwt the best-path decode's words, and the
    swept WER the best-path WER of the search the sweep ran (blank-skip
    where its guard passed, else the full search; lattice beam 4 keeps
    the random model's determinization to seconds)."""
    import dataclasses

    from eesen_tpu_torch.decoder.score import compute_wer

    runs, feats, text = _card_and_cpu_recipes(dev, tmp_path,
                                              lattice_beam=4.0)
    test = feats["cpu"]
    refs = {k: text[k] for k in test}
    lats, sweeps = {}, {}
    for d, run in runs.items():
        before = lstm_cuda.launches
        lats[d] = run.decode_lattices(test)
        if d == "cuda":
            assert lstm_cuda.launches == before + 4
        sweeps[d] = run.score_sweep(test, refs, acwts=(0.5, 0.9, 1.3))
    stats, hyps = runs["cuda"].decode(test, refs)
    words = runs["cuda"].lang.words
    assert sorted(lats["cuda"]) == sorted(lats["cpu"]) == sorted(test)
    for key, clat in lats["cpu"].items():
        for acwt in (0.5, 0.9, 1.3):
            _, w_cpu, c_cpu = clat.scaled(acwt).best_path()
            _, w_card, c_card = lats["cuda"][key].scaled(acwt).best_path()
            assert list(w_card) == list(w_cpu), (key, acwt)
            np.testing.assert_allclose(c_card, c_cpu, rtol=1e-4)
        best = lats["cuda"][key].scaled(0.9).best_path()[1]
        assert [words.sym(w) for w in best] == hyps[key], key
    for acwt, st in sweeps["cpu"].items():
        assert (dataclasses.asdict(sweeps["cuda"][acwt])
                == dataclasses.asdict(st)), acwt
    # the sweep decodes with blank-skip only where its guard passed
    (ok, _), = runs["cuda"]._guard_cache.values()
    if not ok:
        cfg = dataclasses.replace(runs["cuda"].cfg.decode, blank_skip=0.0)
        hyps = {}
        for chunk, _, lens, o in runs["cuda"]._run_search(
                test, sorted(test), cfg, 8):
            for key, (wids, _) in zip(chunk, tbeam.traceback(
                    o, lens, runs["cuda"].graph.final_weight)):
                hyps[key] = [words.sym(w) for w in wids]
        stats = compute_wer(refs, hyps)
    assert sweeps["cuda"][0.9].wer == stats.wer


def test_nnet_roundtrip_on_card(dev, tmp_path):
    """write_eesen_nnet of parameters on the card, read back onto the
    card and onto the CPU: equal bits in every tensor, and the read-back
    model's posteriors on the card equal the original's bit for bit
    (the same kernels on the same inputs)."""
    from eesen_tpu_torch.models.model import AcousticModelConfig, init_model
    from eesen_tpu_torch.models.serialize import (
        read_eesen_nnet, write_eesen_nnet,
    )
    from eesen_tpu_torch.recipes.run import posteriors
    from eesen_tpu_torch.training.optim import tree_leaves

    for bidirectional in (True, False):
        cfg = AcousticModelConfig(input_dim=40, cell_dim=64, num_layers=2,
                                  num_targets=30,
                                  bidirectional=bidirectional)
        params = init_model(torch.Generator().manual_seed(1), cfg, dev)
        path = str(tmp_path / f"final_{bidirectional}.nnet")
        write_eesen_nnet(path, params, cfg, parallel=True)
        back, bcfg = read_eesen_nnet(path, device=dev)
        host, _ = read_eesen_nnet(path, device="cpu")
        assert bcfg == cfg
        for a, b, c in zip(tree_leaves(params), tree_leaves(back),
                           tree_leaves(host)):
            assert b.device == a.device and b.dtype == torch.float32
            assert torch.equal(a, b) and torch.equal(a.cpu(), c)
        feats = np.random.default_rng(2).standard_normal(
            (3, 50, 40)).astype(np.float32)
        lens = [50, 41, 17]
        before = lstm_cuda.launches
        want = posteriors(params, cfg, feats, lens, device=dev)
        got = posteriors(back, bcfg, feats, lens, device=dev)
        assert lstm_cuda.launches == before + 2 * (
            4 if bidirectional else 2)
        assert torch.equal(got, want)


def test_ctc_align_on_card_matches_cpu(dev):
    """ctc_viterbi on the card against the CPU: psi equal, delta within
    float32 rounding, and equal alignments (mixed lengths, a label-free
    row)."""
    from eesen_tpu_torch.ops.align import ctc_align, ctc_viterbi

    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 60, 9)).astype(np.float32) * 2.0
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    lens = np.array([60, 47, 12, 30])
    lab_lens = np.array([7, 5, 3, 0])
    labels = rng.integers(1, 9, (4, 7)).astype(np.int32)
    labels[np.arange(7)[None, :] >= lab_lens[:, None]] = 0
    lp_d = torch.from_numpy(lp).to(dev)
    d_d, p_d = ctc_viterbi(lp_d, lens, labels, lab_lens)
    d_c, p_c = ctc_viterbi(torch.from_numpy(lp), lens, labels, lab_lens)
    assert d_d.is_cuda and p_d.dtype == torch.int8
    assert torch.equal(p_d.cpu(), p_c)
    torch.testing.assert_close(d_d.cpu(), d_c, rtol=1e-6, atol=1e-4)
    for a, b in zip(ctc_align(lp_d, lens, labels, lab_lens),
                    ctc_align(torch.from_numpy(lp), lens, labels, lab_lens)):
        np.testing.assert_array_equal(a, b)


def test_dense_decoder_on_card_matches_cpu(dev):
    """decode_dense on the card: the CPU's winning-slot tables and final
    scores, words and costs."""
    from eesen_tpu_torch.decoder.dense import (
        DenseDeviceGraph, build_dense_graph, decode_dense, make_dense_decoder,
    )

    g, rng = small_graph()
    dg = build_dense_graph(g, in_degree=4, closure_in_degree=4)
    assert len(dg.ehub_state) or len(dg.chub_state)
    ll = rng.standard_normal((3, 20, 6)).astype(np.float32) * 3.0
    ll -= np.log(np.exp(ll).sum(-1, keepdims=True))
    lens = np.array([20, 15, 9])
    dec = make_dense_decoder(dg, 0.9)
    out_d = dec(ll, lens, DenseDeviceGraph.put(dg, device=dev))
    out_c = dec(ll, lens, DenseDeviceGraph.put(dg, device="cpu"))
    assert out_d.emit_arg.is_cuda
    for a, b in zip(out_d, out_c):
        assert torch.equal(a.cpu(), b)
    res_d = decode_dense(ll, lens, dg, DenseDeviceGraph.put(dg, device=dev))
    res_c = decode_dense(ll, lens, dg, DenseDeviceGraph.put(dg, device="cpu"))
    for (w_d, c_d), (w_c, c_c) in zip(res_d, res_c):
        assert w_d == w_c
        np.testing.assert_allclose(c_d, c_c, rtol=1e-5)


def test_cli_net_output_extract_on_card_matches_cpu(dev, tmp_path):
    """net-output-extract --device cuda (kernel 1 at B=1, unpadded T, two
    launches an utterance for one bidirectional layer) against --device
    cpu on a one-layer f32 model."""
    from eesen_tpu_torch.io.kaldi_io import read_rspecifier, write_ark
    from eesen_tpu_torch.models.model import AcousticModelConfig, init_model
    from eesen_tpu_torch.tools import cli

    cfg = AcousticModelConfig(input_dim=6, cell_dim=8, num_layers=1,
                              num_targets=5, compute_dtype=torch.float32,
                              state_bf16=False)
    params = init_model(torch.Generator().manual_seed(3), cfg, "cpu")
    model = str(tmp_path / "m.pt")
    cli.save_model_blob(model, {"params": params, "config": cfg})
    rng = np.random.default_rng(5)
    feats = {f"u{i}": rng.standard_normal((9 + 7 * i, 6)).astype(np.float32)
             for i in range(3)}
    write_ark(str(tmp_path / "f.ark"), feats.items())
    outs = {}
    for device in ("cuda", "cpu"):
        before = lstm_cuda.launches
        assert cli.main(["--device", device, "net-output-extract", model,
                         f"ark:{tmp_path}/f.ark",
                         f"ark:{tmp_path}/{device}.ark"]) == 0
        outs[device] = (dict(read_rspecifier(f"ark:{tmp_path}/{device}.ark")),
                        lstm_cuda.launches - before)
    assert outs["cuda"][1] == 2 * len(feats) and outs["cpu"][1] == 0
    for k in feats:
        np.testing.assert_allclose(outs["cuda"][0][k], outs["cpu"][0][k],
                                   rtol=1e-5, atol=1e-5)
