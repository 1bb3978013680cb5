"""The operation and byte counts against hand counts at two shapes."""

import pytest

from benchmark import common
from benchmark.metrics import costs


@pytest.mark.parametrize("t,b,d,h,valid", [(768, 128, 120, 320, 90000),
                                           (512, 128, 1280, 640, 60000)])
def test_lstm_bounds_by_hand(t, b, d, h, valid):
    flops_f = 2 * valid * (d + h) * 4 * h
    bytes_f = (t * b * d * 2 + t * b * 4 + d * 4 * h * 2 + 4 * h * 4
               + h * 4 * h * 2 + 3 * h * 4          # in
               + t * b * h * 2 * 2 + t * b * 4 * h * 2)   # m, c, gates
    assert costs.lstm_fwd_bytes(t, b, d, h) == bytes_f
    want = max(flops_f / 989e12, bytes_f / 3.35e12)
    assert costs.lstm_fwd_bound(t, b, d, h, valid) == pytest.approx(want)
    bytes_b = (t * b * d * 2 + t * b * 4 + t * b * 4 * h * 2
               + 3 * t * b * h * 2 + d * 4 * h * 2 + h * 4 * h * 2
               + 3 * h * 4                           # in
               + t * b * d * 2 + (d + h) * 4 * h * 4 + 7 * h * 4)
    assert costs.lstm_bwd_bytes(t, b, d, h) == bytes_b
    want = max(2 * flops_f / 989e12, bytes_b / 3.35e12)
    assert costs.lstm_bwd_bound(t, b, d, h, valid) == pytest.approx(want)


def test_step_bounds_cover_every_direction_layer():
    cfg = common.cell("wsj_phn.train")["config"]
    fwd, bwd = costs.step_bounds(cfg, 896, 128, 80000)
    assert len(fwd) == len(bwd) == 8
    assert fwd[0] == costs.lstm_fwd_bound(896, 128, 120, 320, 80000)
    assert fwd[2] == costs.lstm_fwd_bound(896, 128, 640, 320, 80000)


@pytest.mark.parametrize("name,per_frame", [
    # 3 x (layer 0 + layers 1-3 + output), by hand
    ("wsj_phn.train", 3 * (2 * 2 * 1280 * (120 + 320)
                           + 3 * 2 * 2 * 1280 * (640 + 320) + 2 * 640 * 72)),
    ("librispeech_char.train", 3 * (2 * 2 * 2560 * (360 + 640)
                                    + 3 * 2 * 2 * 2560 * (1280 + 640)
                                    + 2 * 1280 * 30)),
])
def test_model_flops_by_hand(name, per_frame):
    cfg = common.cell(name)["config"]
    assert costs.model_flops_per_frame(cfg) == per_frame


@pytest.mark.parametrize("b,m,k", [(32, 8192, 512), (8, 16384, 512)])
def test_dedup_bound_by_hand(b, m, k):
    nbytes = b * m * (4 + 4) + b * k * (4 + 4 + 4)
    want = max(8 * b * m / 989e12, nbytes / 3.35e12)
    assert costs.dedup_bound(b, m, k) == pytest.approx(want)
