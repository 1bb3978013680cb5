"""Host arithmetic of the port's kernels, on hand-computed cases: the
recurrence plans of kernels 1 and 3 (ops/lstm_cuda.fwd_plan and bwd_plan:
CTAs per cluster, rows per cluster, units per CTA, resident rows of the
W_m slice) and their shared memory, kernel 3's W_m slice layout, the
route choice's accepted set, the product kernel's split, and kernels 6
and 7's launch plan (ops/ctc_cuda.ctc_plan).  The card tests hold the
same formulas equal to the library's exported ones."""

import numpy as np
import pytest
import torch

from eesen_tpu_torch.ops import ctc_cuda, lstm_cuda

LIMIT = 232448


@pytest.mark.parametrize("b,h,bf16,want", [
    # WSJ serving: 8 CTAs of 40 units hold their whole 320 x 160 slice
    (8, 320, True, (8, 16, 40, 320)),
    # WSJ training: 32 rows a cluster, still whole at 8 CTAs
    (128, 320, True, (8, 32, 40, 320)),
    # LibriSpeech serving: 16 CTAs, 512 of 640 input rows resident
    (8, 640, True, (16, 16, 40, 512)),
    # LibriSpeech training: 320 of 640 resident (the operand is larger)
    (128, 640, True, (16, 32, 40, 320)),
    # H=1024: 256 rows at 16 rows a cluster, 64 at 32
    (8, 1024, True, (16, 16, 64, 256)),
    (128, 1024, True, (16, 32, 64, 64)),
    # f32: 4-byte operand; at H=1024 and B>16 the rows halve to 16
    (8, 320, False, (16, 16, 20, 320)),
    (128, 1024, False, (16, 16, 64, 75)),
    # a narrow toy: the operand rows pad to 64
    (3, 32, True, (8, 16, 4, 64)),
    # kernel 4's widths: U 72, and 164 at the plan's widest (rows halve)
    (128, 1152, True, (16, 32, 72, 0)),
    (128, 2624, True, (16, 16, 164, 0)),
    # an odd width: U 42, the operand rows pad to 384, all resident
    (128, 321, True, (8, 32, 42, 384)),
])
def test_fwd_plan(b, h, bf16, want):
    plan = lstm_cuda.fwd_plan(b, h, bf16)
    assert tuple(plan) == want
    assert lstm_cuda.fwd_smem_bytes(h, *want[1:], bf16) <= LIMIT


@pytest.mark.parametrize("h,rows,units,kres,bf16,want", [
    # 16x160 f32 pre + 2 x 16x40 f32 carries + 2 x 16x320 bf16 operand
    # + 320x160 bf16 slice
    (320, 16, 40, 320, True, 10240 + 5120 + 20480 + 102400),
    (640, 32, 40, 320, True, 20480 + 10240 + 81920 + 102400),
    (1024, 16, 64, 75, False, 16384 + 8192 + 131072 + 76800),
    (33, 16, 4, 64, True, 1024 + 512 + 4096 + 2048),    # H pads to 64
    # kernel 4's widest plan
    (2624, 16, 164, 0, True, 41984 + 20992 + 167936),
])
def test_fwd_smem_bytes(h, rows, units, kres, bf16, want):
    assert lstm_cuda.fwd_smem_bytes(h, rows, units, kres, bf16) == want


def test_units_and_padding():
    assert [lstm_cuda.fwd_units(h, 8) for h in (320, 33, 8, 1)] == \
        [40, 6, 2, 2]
    assert lstm_cuda.fwd_units(640, 16) == 40
    assert [lstm_cuda.fwd_kpad(h, True) for h in (320, 64, 65, 1)] == \
        [320, 64, 128, 64]
    assert lstm_cuda.fwd_kpad(65, False) == 65


@pytest.mark.parametrize("h", [1, 7, 32, 100, 320, 511, 640, 777, 1024])
@pytest.mark.parametrize("b", [1, 8, 16, 17, 128, 1000])
def test_fused_launch_keeps_every_shape_it_took(b, h):
    """Every shape the one-block kernel 1 took (any H <= 1024 whose
    shared memory fit at one row a block) is still taken, for both
    compute dtypes, with a plan that fits and owns every unit."""
    for d in (1, 120, 640, 1280):
        split = max(1, min(4, 1024 // h))
        old = 4 * ((d + h) + 2 * h + split * 4 * h) <= LIMIT and \
            4 * min(2, b) * (13 * h + split * h) <= LIMIT
        for bf16 in (True, False):
            got = lstm_cuda.fused_launch(b, d, h, bf16)
            assert got is not None or not old
            if got is not None:
                p = got.fwd
                assert p.units * p.cluster >= h and p.units % 2 == 0
                assert p.rows * p.units <= \
                    lstm_cuda.FWD_THREADS * lstm_cuda.FWD_EPT
                assert p.rows % (16 if bf16 else 4) == 0
                assert p.kres <= lstm_cuda.fwd_kpad(h, bf16)
                assert not bf16 or p.kres % 64 == 0
                assert lstm_cuda.fwd_smem_bytes(
                    h, p.rows, p.units, p.kres, bf16) <= LIMIT
                q = got.bwd
                assert q.units * q.cluster >= h and q.rows * q.units <= 2048
                assert q.rows % (16 if bf16 else 4) == 0
                assert not bf16 or (q.units % 4 == 0 and q.kres % 8 == 0)
                assert q.kres <= (-(-h // 8) * 8 if bf16 else h)
                assert lstm_cuda.bwd_smem_bytes(*q, bf16) <= LIMIT


# Kernel 3's plan.  bf16: U = ceil(H/C) up to a multiple of 4, SW = 2U+4
# words a row; smem = 4 * (2*C*rows*U + (rows + kres)*SW).  f32: SW = 4U.
# 8 CTAs are kept when the whole slice (H rows, to 8 on bf16) fits, else
# 16 with as many whole rows (8-row tiles on bf16) as fit in 232448 bytes.
# Rows: 16 while ceil(B/16)*C <= 112 CTAs (one wave), else 32.
@pytest.mark.parametrize("b,h,bf16,want", [
    # H=320 bf16, C=8, U=40, SW=84: 81920/2 + 5376 + 107520 fit; B=128
    # takes 8 clusters of 8 (64 CTAs), still 16 rows
    (1, 320, True, (8, 16, 40, 320)),
    (8, 320, True, (8, 16, 40, 320)),
    (20, 320, True, (8, 16, 40, 320)),
    (128, 320, True, (8, 16, 40, 320)),
    # H=640 bf16: C=8 (U=80, 16 rows: 208 of 640 resident) falls short, so
    # C=16, U=40: 16 rows leave 145152 B = 432 rows of 336 B
    (1, 640, True, (16, 16, 40, 432)),
    (8, 640, True, (16, 16, 40, 432)),
    (20, 640, True, (16, 16, 40, 432)),
    # B=128 at 16 rows would be 8 x 16 = 128 CTAs: 32 rows, whose
    # 163840 + 10752 B leave 57856 B: 172 rows, 168 in whole tiles
    (128, 640, True, (16, 32, 40, 168)),
    # H=1024 bf16, C=16, U=64: 32 rows' receive slots (262144 B) do not
    # fit, 16 rows: 131072 + 8448 leave 92928 B = 176 rows of 528 B
    (1, 1024, True, (16, 16, 64, 176)),
    (8, 1024, True, (16, 16, 64, 176)),
    (20, 1024, True, (16, 16, 64, 176)),
    (128, 1024, True, (16, 16, 64, 176)),
    # H=320 f32: C=8 holds 219 of 320 columns; C=16, U=20: the whole
    # [80, 320] float slice (102400 B) fits beside 16 or 32 rows
    (1, 320, False, (16, 16, 20, 320)),
    (8, 320, False, (16, 16, 20, 320)),
    (20, 320, False, (16, 16, 20, 320)),
    (128, 320, False, (16, 32, 20, 320)),
    # H=640 f32, C=16, U=40: 16 rows leave 140160 B = 219 columns of 640 B,
    # 32 rows 48000 B = 75
    (1, 640, False, (16, 16, 40, 219)),
    (8, 640, False, (16, 16, 40, 219)),
    (20, 640, False, (16, 16, 40, 219)),
    (128, 640, False, (16, 32, 40, 75)),
    # H=1024 f32, C=16, U=64, 16 rows: 131072 + 16384 leave 84992 B = 83
    (1, 1024, False, (16, 16, 64, 83)),
    (8, 1024, False, (16, 16, 64, 83)),
    (20, 1024, False, (16, 16, 64, 83)),
    (128, 1024, False, (16, 16, 64, 83)),
])
def test_bwd_plan(b, h, bf16, want):
    plan = lstm_cuda.bwd_plan(b, h, bf16)
    assert tuple(plan) == want
    c, rows, units, kres = want
    assert lstm_cuda.bwd_smem_bytes(c, rows, units, kres, bf16) <= LIMIT
    assert units * c >= h and rows * units <= 512 * 4
    assert lstm_cuda.fused_launch(b, 64, h, bf16).bwd == plan


@pytest.mark.parametrize("cluster,rows,units,kres,bf16,want", [
    # 2 x 8 x 16 x 40 f32 slots + (16 + 320) rows of 84 words
    (8, 16, 40, 320, True, 4 * (10240 + 336 * 84)),
    (16, 32, 40, 168, True, 4 * (40960 + 200 * 84)),
    (16, 16, 64, 176, True, 4 * (32768 + 192 * 132)),
    # f32: the operand [rows, 4U] and the slice [4U, kres] floats
    (16, 32, 20, 320, False, 4 * (20480 + 32 * 80 + 80 * 320)),
    (16, 16, 64, 83, False, 4 * (32768 + 16 * 256 + 256 * 83)),
])
def test_bwd_smem_bytes(cluster, rows, units, kres, bf16, want):
    assert lstm_cuda.bwd_smem_bytes(cluster, rows, units, kres, bf16) == want


def test_bwd_units_and_row_words():
    assert [lstm_cuda.bwd_units(h, 8, True) for h in (320, 33, 8, 1)] == \
        [40, 8, 4, 4]
    assert [lstm_cuda.bwd_units(h, 8, False) for h in (320, 33, 8, 1)] == \
        [40, 5, 1, 1]
    assert lstm_cuda.bwd_units(640, 16, True) == 40
    assert lstm_cuda.bwd_units(1024, 16, True) == 64
    # bf16 rows 4 mod 8 words apart; f32 rows unpadded
    assert [lstm_cuda.bwd_row_words(u, True) for u in (4, 40, 64)] == \
        [12, 84, 132]
    assert lstm_cuda.bwd_row_words(20, False) == 80


@pytest.mark.parametrize("h,bf16", [(20, True), (37, True), (20, False),
                                    (37, False)])
def test_bwd_weight_slices_layout(h, bf16):
    """CTA q's slice holds W_m[u', g*H + q*U + u] at row u', column
    g*U + u (bf16: [C, Hp, 2*SW], zero past H and past 4U; f32: [C, 4U,
    H], column-major), and zero for units past H."""
    plan = lstm_cuda.bwd_plan(3, h, bf16)
    c, u = plan.cluster, plan.units
    w = torch.from_numpy(np.random.default_rng(h).standard_normal(
        (h, 4 * h)).astype(np.float32))
    w = w.to(torch.bfloat16) if bf16 else w
    got = lstm_cuda.bwd_weight_slices(w, plan, bf16)
    hp = -(-h // 8) * 8
    want_shape = (c, hp, 2 * lstm_cuda.bwd_row_words(u, True)) if bf16 \
        else (c, 4 * u, h)
    assert tuple(got.shape) == want_shape and got.dtype == w.dtype
    assert got.is_contiguous()
    for q in range(c):
        for g in range(4):
            for k in range(u):
                hu = q * u + k
                col = got[q, :h, g * u + k] if bf16 else got[q, g * u + k]
                want = w[:, g * h + hu] if hu < h else torch.zeros(h, dtype=w.dtype)
                assert torch.equal(col, want), (q, g, k)
    if bf16:
        assert not got[:, h:].any() and not got[:, :, 4 * u:].any()


@pytest.mark.parametrize("h", [1025, 1152, 2048])
@pytest.mark.parametrize("b", [1, 8, 128])
def test_fused_launch_still_refuses_past_1024(b, h):
    """The route stays where it was: every H above 1024 goes to the v1
    route (kernels 4 and 5), for both compute dtypes and any input
    width."""
    for d in (1, 640, 1152):
        for bf16 in (True, False):
            assert lstm_cuda.fused_launch(b, d, h, bf16) is None


# The product kernel's plan.  Tiles of 128 x 128; k steps of 64; a split
# product takes the fewest slices (at most 16, each at least 8 k steps)
# whose tiles x slices CTAs fill 90% of the waves of 132 they take, else
# the fullest; then k per slice = ceil(steps / slices) whole steps.
@pytest.mark.parametrize("m,n,k,split,want", [
    # LibriSpeech (B=128, T=768: T*B = 98,304; 4H = 2560), dW_x at D=1280:
    # 10 x 20 = 200 tiles, 1536 k steps; 1 or 2 slices fill 76% of their
    # waves, 3 (600 of 660) 91%: 512 steps a slice
    (1280, 2560, 98304, True, (200, 3, 32768)),
    # dW_x at D=360 (first layer): 3 x 20 = 60 tiles, 2 slices: 120 of 132
    (360, 2560, 98304, True, (60, 2, 49152)),
    # dW_m at H=640, k = T*B - B = 98,176 (1534 steps): 100 tiles fill 76%
    # at 1-4 slices, 500 of 528 at 5: ceil(1534/5) = 307 steps
    (640, 2560, 98176, True, (100, 5, 19648)),
    # WSJ (4H = 1280): dW_x at D=640, 50 tiles: 5 slices (250 of 264)
    (640, 1280, 98304, True, (50, 5, 19712)),
    # dW_x at D=120: 10 tiles: 12 slices (120 of 132)
    (120, 1280, 98304, True, (10, 12, 8192)),
    # dW_m at H=320: 30 tiles: 4 slices (120 of 132), 384 steps
    (320, 1280, 98176, True, (30, 4, 24576)),
    # the projection and dx are not split: 768 x 20 and 768 x 10 tiles
    (98304, 2560, 1280, False, (15360, 1, 1280)),
    (98304, 1280, 2560, False, (7680, 1, 2560)),
    (98304, 1280, 360, False, (7680, 1, 384)),
    # WSJ serving projection (B=8, T=512, D=120): 32 x 10 tiles, 2 steps
    (4096, 1280, 120, False, (320, 1, 128)),
    # ragged: K below one k step; 16 steps allow 2 slices (6 tiles: the
    # fuller of 6 and 12 CTAs); 8 steps allow no split
    (44, 144, 33, True, (2, 1, 64)),
    (200, 300, 1000, True, (6, 2, 512)),
    (1000, 1000, 500, True, (64, 1, 512)),
    (129, 1, 1, True, (2, 1, 64)),
])
def test_gemm_plan(m, n, k, split, want):
    plan = lstm_cuda.gemm_plan(m, n, k, split)
    assert tuple(plan) == want
    tiles, z, ks = plan
    # the slices cover [0, K) exactly once, none empty, whole k steps
    assert ks % 64 == 0 and (z - 1) * ks < k <= z * ks
    assert z <= 16 and (z == 1 or ks >= 8 * 64)


def test_gemm_smem_bytes():
    # 4 stages of two 128 x 64 bf16 tiles, 1024 bytes of alignment slack,
    # a full and an empty barrier per stage
    assert lstm_cuda.GEMM_SMEM_BYTES == 4 * 32768 + 1024 + 64 <= LIMIT


# Kernels 6 and 7 (ops/ctc_cuda.ctc_plan).  Shared memory: two exchange
# rows of S+2 floats, plus a ring of `depth` rows of S floats at depth >= 2;
# the depth is the largest of 8, 4, 2 that fits, else 1 (no ring).
@pytest.mark.parametrize("s,want", [
    (1, (1, 32, 8, 4 * (2 * 3 + 8 * 1))),
    (3, (1, 32, 8, 4 * (2 * 5 + 8 * 3))),
    # WSJ (L=100): 224 threads, 8-deep ring
    (201, (1, 224, 8, 4 * (2 * 203 + 8 * 201))),
    # LibriSpeech (L=200)
    (401, (1, 416, 8, 4 * (2 * 403 + 8 * 401))),
    # two states a thread from 1025 on: 601 -> 608 threads
    (1201, (2, 608, 8, 4 * (2 * 1203 + 8 * 1201))),
    (4001, (4, 1024, 8, 4 * (2 * 4003 + 8 * 4001))),
    # the last S with an 8-deep ring (232,416 bytes), then 4, then 2
    (5810, (8, 736, 8, 232416)),
    (5811, (8, 736, 4, 4 * (2 * 5813 + 4 * 5811))),
    (9684, (16, 608, 4, 232432)),
    (9685, (16, 608, 2, 4 * (2 * 9687 + 2 * 9685))),
    (14527, (16, 928, 2, 232448)),
    # no ring fits: one register a state, the rows alone
    (14528, (16, 928, 1, 4 * 2 * 14530)),
    # the largest S taken (its rows are 232,448 bytes), and the first past
    (29054, (32, 928, 1, 232448)),
    (29055, None),
    (32769, None),
])
def test_ctc_plan(s, want):
    plan = ctc_cuda.ctc_plan(s)
    assert (None if plan is None else tuple(plan)) == want


def test_ctc_plan_keeps_every_s_it_took():
    """The accepted set is the one before the ring: a thread owns at most
    32 states and the two rows of S+2 floats fit; the depth falls to 1
    exactly where a 2-deep ring no longer fits beside them, and every
    (states a thread, depth) pair is one the library instantiates
    (csrc/ctc_alpha_beta.cu `dispatch`)."""
    pairs = set()
    for s in range(1, 33000):
        need = -(-s // 1024)
        spt = 1 << (need - 1).bit_length()
        took = spt <= 32 and 2 * (s + 2) * 4 <= LIMIT
        plan = ctc_cuda.ctc_plan(s)
        assert (plan is not None) == took, s
        if plan is None:
            continue
        assert plan.spt == spt and plan.threads * spt >= s
        assert plan.threads % 32 == 0 and plan.threads <= 1024
        assert plan.smem_bytes <= LIMIT
        assert (plan.depth == 1) == (2 * (s + 2) * 4 + 2 * s * 4 > LIMIT), s
        if plan.depth < 8:
            bigger = 2 * plan.depth if plan.depth > 1 else 2
            assert 2 * (s + 2) * 4 + bigger * s * 4 > LIMIT, s
        pairs.add((plan.spt, plan.depth))
    assert pairs == {(1, 8), (2, 8), (4, 8), (8, 8), (8, 4), (16, 4),
                     (16, 2), (16, 1), (32, 1)}


# Kernels 4 and 5 (ops/lstm_v1_cuda.fwd_launch / bwd_launch): the cluster
# recurrence where its plan takes H, else the thread-per-unit kernel, whose
# plan is (rows per block, threads): ceil(H/1024) units a thread, threads
# 32 * ceil(H / (32 * units a thread)).
@pytest.mark.parametrize("b,h,fwd,bwd", [
    # the route's width at serving: one 16-CTA cluster each; kernel 4 keeps
    # 192 of 1152 input rows resident, kernel 5 120 of 1152 rows u'
    (8, 1152, ("cluster", (16, 16, 72, 192), 1, True),
     ("cluster", (16, 16, 72, 120), 1, True)),
    # B=128: kernel 4 in 4 clusters of 16 CTAs, 32 rows each, nothing
    # resident (the 32-row operand fills the shared memory); kernel 5 in 8
    # clusters of 8 CTAs (U=144, 16 rows: 2304 elements, 5 a thread, 56 rows
    # u' resident): 64 CTAs in one wave, where bwd_plan's 16-CTA plan
    # (16, 16, 72, 120) needs 8 clusters of 16 and the card holds 7
    (128, 1152, ("cluster", (16, 32, 72, 0), 4, True),
     ("cluster", (8, 16, 144, 56), 8, True)),
    # either side of kernel 5's limit: at H=1664 the 16-row receive slots
    # and operand take 226560 of 232448 bytes; at 1665 (U=108) 235264
    (1, 1664, ("cluster", (16, 16, 104, 64), 1, True),
     ("cluster", (16, 16, 104, 0), 1, True)),
    (128, 1664, ("cluster", (16, 16, 104, 64), 8, False),
     ("cluster", (16, 16, 104, 0), 8, False)),
    (8, 1665, ("cluster", (16, 16, 106, 64), 1, True),
     ("thread_per_unit", (2, 864), None, None)),
    # either side of kernel 4's limit: at H=2624 (U=164) the 16-row
    # pre-activations, carries and operand take 230912 bytes; at 2625
    # (U=166, operand rows padded to 2688) 235776
    (8, 2624, ("cluster", (16, 16, 164, 0), 1, True),
     ("thread_per_unit", (2, 896), None, None)),
    (128, 2625, ("thread_per_unit", (2, 896), None, None),
     ("thread_per_unit", (2, 896), None, None)),
    # a narrow cell: the cluster plans of kernels 1 and 3 at B=20
    (20, 40, ("cluster", (8, 32, 6, 64), 1, True),
     ("cluster", (8, 16, 8, 40), 2, True)),
])
def test_v1_launch(b, h, fwd, bwd):
    """(design, plan, clusters, whether they fit in one wave of
    BWD_WAVE_CTAS CTAs) of kernels 4 and 5."""
    from eesen_tpu_torch.ops import lstm_v1_cuda

    for got, (design, plan, clusters, wave) in (
            (lstm_v1_cuda.fwd_launch(b, h), fwd),
            (lstm_v1_cuda.bwd_launch(b, h), bwd)):
        assert (got.design, tuple(got.plan)) == (design, plan)
        if design == "cluster":
            assert -(-b // got.plan.rows) == clusters
            assert lstm_cuda.one_wave(b, got.plan.cluster,
                                      got.plan.rows) == wave


def _old_fwd_plan(b, h, bf16):
    """fwd_plan before the v1 route used it (kept here verbatim, with its
    constants, to pin kernel 1's plans)."""
    s = 2 if bf16 else 4
    kp = -(-h // 64) * 64 if bf16 else h
    step, min_rows = (64, 16) if bf16 else (1, 4)
    plan = None
    for cluster in (8, 16):
        u = -(-h // cluster)
        units = u + (u & 1)
        rows = 16 if b <= 16 else 32
        smem = lambda r, k: (r * 4 * units * 4 + 2 * r * units * 4
                             + 2 * r * kp * s + k * 4 * units * s)
        while rows > min_rows and smem(rows, 0) > LIMIT:
            rows //= 2
        free = LIMIT - smem(rows, 0)
        if free < 0:
            continue
        kres = min(kp, free // (4 * units * s) // step * step)
        plan = (cluster, rows, units, kres)
        if kres == kp:
            break
    return plan


def _old_bwd_plan(b, h, bf16):
    """bwd_plan before its v1 variant (kept here verbatim, with its
    constants, to pin kernel 3's plans)."""
    full = -(-h // 8) * 8 if bf16 else h
    step, min_rows = (8, 16) if bf16 else (1, 4)
    plan = None
    for cluster in (8, 16):
        u = -(-h // cluster)
        units = -(-u // 4) * 4 if bf16 else u
        sw = 2 * units + 4 if bf16 else 4 * units
        smem = lambda r, k: 4 * (2 * cluster * r * units + (r + k) * sw)
        rows = 16 if -(-b // 16) * cluster <= 112 else 32
        while rows > min_rows and (rows * units > 2048
                                   or smem(rows, 0) > LIMIT):
            rows //= 2
        free = LIMIT - smem(rows, 0)
        if free < 0 or rows * units > 2048:
            continue
        plan = (cluster, rows, units, min(full, free // (4 * sw) // step
                                          * step))
        if plan[3] == full:
            break
    return plan


@pytest.mark.parametrize("h", [320, 640, 1024])
def test_kernel_1_and_3_plans_are_unchanged(h):
    """The plans of kernels 1 and 3 at the recipes' widths (and at 1024,
    the fused route's widest), at every B up to 300 and both compute
    dtypes, are the ones they had before kernels 4 and 5 shared their
    recurrences."""
    for b in range(1, 301):
        for bf16 in (True, False):
            got = lstm_cuda.fused_launch(b, 64, h, bf16)
            assert tuple(got.fwd) == _old_fwd_plan(b, h, bf16), (b, bf16)
            assert tuple(got.bwd) == _old_bwd_plan(b, h, bf16), (b, bf16)


@pytest.mark.parametrize("b", [1, 8, 128])
def test_v1_launch_keeps_every_h_it_took(b):
    """Every H the thread-per-unit kernels took (at one row a block, 16*H
    bytes of shared memory forward, 40*H backward: H <= 14528 and <= 5811)
    is still taken, by the cluster design up to its plan's limit (2624 and
    1664 at any B) and by the thread-per-unit one above, with a plan that
    fits and owns every unit; one past raises, as before."""
    from eesen_tpu_torch.ops import lstm_v1_cuda

    for which, per_h, limit in (("fwd", 16, 2624), ("bwd", 40, 1664)):
        launch = getattr(lstm_v1_cuda, f"{which}_launch")
        top = LIMIT // per_h
        for h in range(1, top + 1):
            got = launch(b, h)
            assert got.design == ("cluster" if h <= limit
                                  else "thread_per_unit"), (which, h)
            if got.design == "thread_per_unit":
                rows, threads = got.plan
                assert per_h * rows * h <= LIMIT
                assert threads % 32 == 0 and threads <= 1024
                assert threads * -(-h // 1024) >= h
            elif which == "fwd":
                p = got.plan
                assert p.units * p.cluster >= h and p.units % 2 == 0
                assert p.rows * p.units <= \
                    lstm_cuda.FWD_THREADS * lstm_cuda.FWD_EPT
                assert p.rows % 16 == 0 and p.kres % 64 == 0
                assert p.kres <= lstm_cuda.fwd_kpad(h, True)
                assert lstm_cuda.fwd_smem_bytes(h, p.rows, p.units, p.kres,
                                                True) <= LIMIT
            else:
                q = got.plan
                assert q.units * q.cluster >= h and q.units % 4 == 0
                assert q.rows % 16 == 0 and q.kres % 8 == 0
                assert q.rows * q.units <= 512 * lstm_cuda.BWD_EPT_V1
                assert q.kres <= -(-h // 8) * 8
                assert lstm_cuda.bwd_smem_bytes(*q, True) <= LIMIT
        with pytest.raises(ValueError):
            launch(b, top + 1)
