"""Operations, bytes and least times of the kernels and the step, from
shapes (the H100's published peaks: common.H100_*).

A kernel's bound is max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s): its
operations at the bf16 tensor-core rate, or each input byte read once and
each output byte written once.  Products count 2 operations a
multiply-add over the real (unpadded) frames; bytes count the arrays as
the kernels take them, padding included.
"""

from __future__ import annotations

from typing import Dict, List

from benchmark.common import H100_BF16_FLOPS, H100_HBM_BYTES_PER_S

BF16, F32 = 2, 4


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_PER_S)


def layer_dims(cfg: Dict) -> List[int]:
    """Each layer's input width D."""
    h = cfg["cell_dim"]
    return [cfg["input_dim"] if i == 0 else 2 * h
            for i in range(cfg["num_layers"])]


def lstm_fwd_bytes(t: int, b: int, d: int, h: int) -> int:
    """Kernel 1 with the training residuals: x, mask, W_x, bias, W_m and
    the peepholes in; m, c and the gates out (m and c in bf16)."""
    ins = t * b * d * BF16 + t * b * F32 + d * 4 * h * BF16 + 4 * h * F32 \
        + h * 4 * h * BF16 + 3 * h * F32
    outs = 2 * t * b * h * BF16 + t * b * 4 * h * BF16
    return ins + outs


def lstm_fwd_bound(t: int, b: int, d: int, h: int, valid: int) -> float:
    """Seconds: 2 * 4H * (D + H) operations a real frame."""
    return _bound(2.0 * valid * (d + h) * 4 * h, lstm_fwd_bytes(t, b, d, h))


def lstm_bwd_bytes(t: int, b: int, d: int, h: int) -> int:
    """Kernel 3: x, mask, gates, c, m, dm, W_x, W_m, peepholes in; dx,
    dW_x, dW_m, the bias and peephole gradients out."""
    ins = t * b * d * BF16 + t * b * F32 + t * b * 4 * h * BF16 \
        + 3 * t * b * h * BF16 + d * 4 * h * BF16 + h * 4 * h * BF16 \
        + 3 * h * F32
    outs = t * b * d * BF16 + (d + h) * 4 * h * F32 + 7 * h * F32
    return ins + outs


def lstm_bwd_bound(t: int, b: int, d: int, h: int, valid: int) -> float:
    """Seconds: dx, dW_x, dW_m and the recurrent product, twice the
    forward's operations."""
    return _bound(4.0 * valid * (d + h) * 4 * h, lstm_bwd_bytes(t, b, d, h))


def step_bounds(cfg: Dict, t: int, b: int, valid: int):
    """([kernel 1 bounds], [kernel 3 bounds]) of one step's launches, two
    directions a layer."""
    h = cfg["cell_dim"]
    fwd, bwd = [], []
    for d in layer_dims(cfg):
        fwd += [lstm_fwd_bound(t, b, d, h, valid)] * 2
        bwd += [lstm_bwd_bound(t, b, d, h, valid)] * 2
    return fwd, bwd


def model_flops_per_frame(cfg: Dict) -> float:
    """Forward and backward FLOPs a real frame: 2 * 4H * (D + H) a
    direction-layer and 2 * 2H * V for the output affine, forward; the
    backward twice that.  Nothing for the gates' elementwise work."""
    h, v = cfg["cell_dim"], cfg["num_targets"]
    fwd = sum(2 * 2.0 * 4 * h * (d + h) for d in layer_dims(cfg))
    fwd += 2.0 * 2 * h * v
    return 3.0 * fwd


def dedup_bound(b: int, m: int, k: int) -> float:
    """Kernel 2 on one merge of m lanes a row: each lane's state and
    score read once, the k survivors' state, score and lane written
    once; a handful of operations a lane, far below the bytes."""
    return _bound(8.0 * b * m, b * m * 8 + b * k * 12)
