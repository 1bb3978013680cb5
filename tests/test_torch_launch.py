"""Host arithmetic of the port's cluster kernels, on hand-computed cases:
kernel 1's recurrence plan (ops/lstm_cuda.fwd_plan: CTAs per cluster, rows
per cluster, units per CTA, resident rows of the W_m slice) and shared
memory, and the route choice's accepted set.  The card tests hold the same
formulas equal to the library's exported ones."""

import pytest

from eesen_tpu_torch.ops import lstm_cuda

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
                assert p.rows % (16 if bf16 else 4) == 0
                assert p.kres <= lstm_cuda.fwd_kpad(h, bf16)
                assert not bf16 or p.kres % 64 == 0
                assert lstm_cuda.fwd_smem_bytes(
                    h, p.rows, p.units, p.kres, bf16) <= LIMIT
