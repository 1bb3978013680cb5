"""Operations and bytes of a Conformer-CTC training step and of its
relative-position attention op, from shapes (configs/conformer_*.json;
the H100's published peaks: common.H100_*).

Products count 2 operations a multiply-add over each row's real
(unpadded) frames: T' = floor((floor((T+1)/2)+1)/2) after the x4
subsampling, T1 = floor((T+1)/2) after its first convolution.  The
backward counts twice the forward, except for the first convolution,
whose input (the features) takes no gradient: its weight gradient
alone, once the forward.  Elementwise work, the norms and the softmax
count nothing.

The attention op's count is the mechanism's work, whatever computes it:
the three T' x T' products per row and layer, (q+u) k^T, (q+v) p^T
(counted at T' columns) and softmax . V, 6 T'^2 d operations forward and
twice that backward, nothing recomputed; its bytes are q, k, v, p, u, v,
out and the log-sum-exp, and their gradients, each read or written once
at the op's dtypes over the padded batch, and no T' x T' array.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.common import H100_BF16_FLOPS, H100_HBM_BYTES_PER_S

F32 = 4
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def half(n):
    """One 3x3 stride-2 convolution with padding 1: floor((n+1)/2)."""
    return (n + 1) // 2


def subsampled(n):
    return half(half(n))


def frame_flops(cfg: Dict) -> Dict[str, float]:
    """Forward operations a subsampled frame, by part, outside the
    attention's T' x T' products and the positional projection."""
    d, c = cfg["d_model"], cfg["subsampling_conv_channels"]
    ff = cfg["ff_expansion_factor"] * d
    f2 = subsampled(cfg["input_dim"])
    layer = (2 * 2 * 2 * d * ff        # two feed-forward blocks, two products
             + 4 * 2 * d * d           # q, k, v, out
             + 2 * d * 2 * d           # pointwise conv 1 (to 2d, for GLU)
             + 2 * d * d)              # pointwise conv 2
    return {"layers": cfg["n_layers"] * layer,
            "depthwise": cfg["n_layers"] * 2 * d * cfg["conv_kernel_size"],
            "conv2": 2 * 9 * c * c * f2,
            "subsample_out": 2 * c * f2 * d,
            "out": 2 * d * cfg["num_targets"]}


def conv1_flops(cfg: Dict, t1: int) -> float:
    """The first convolution's forward over t1 of its output frames."""
    return 2.0 * 9 * cfg["subsampling_conv_channels"] * half(
        cfg["input_dim"]) * t1


def attention_flops(cfg: Dict, lengths) -> float:
    """The attention's T' x T' products, forward, over the rows' real
    lengths and all layers: 6 T'^2 d a row and layer."""
    t = subsampled(np.asarray(lengths, dtype=np.int64))
    return 6.0 * cfg["d_model"] * cfg["n_layers"] * float((t * t).sum())


def pos_flops(cfg: Dict, lengths) -> float:
    """The per-layer projection of the 2T'-1 relative positions of the
    batch's longest row, forward."""
    t = int(subsampled(np.asarray(lengths, dtype=np.int64)).max())
    return 2.0 * cfg["d_model"] ** 2 * (2 * t - 1) * cfg["n_layers"]


def step_flops(cfg: Dict, lengths) -> float:
    """Forward and backward operations of one training step over a batch
    of input lengths (padded rows of length 0 count nothing)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    tp = float(subsampled(lengths).sum())
    t1 = float(half(lengths[lengths > 0]).sum())
    fwd = tp * sum(frame_flops(cfg).values()) + attention_flops(
        cfg, lengths) + pos_flops(cfg, lengths)
    c1 = conv1_flops(cfg, t1)
    return 3.0 * fwd + 2.0 * c1


def num_params(cfg: Dict) -> int:
    """Trained parameters at the configuration's widths."""
    d, c, h = cfg["d_model"], cfg["subsampling_conv_channels"], cfg["n_heads"]
    ff = cfg["ff_expansion_factor"] * d
    lin = lambda i, o: i * o + o
    sub = c * 9 + c + c * c * 9 + c + lin(c * subsampled(cfg["input_dim"]), d)
    layer = (2 * (lin(d, ff) + lin(ff, d))       # feed-forward blocks
             + 4 * lin(d, d) + d * d + 2 * d     # attention, W_pos, u, v
             + lin(d, 2 * d) + d * cfg["conv_kernel_size"] + d + lin(d, d)
             + 2 * d                             # BatchNorm
             + 5 * 2 * d)                        # five LayerNorms
    return sub + cfg["n_layers"] * layer + lin(d, cfg["num_targets"])


def attention_bytes(cfg: Dict, b: int, t: int) -> Dict[str, float]:
    """Bytes of one layer's op pair on a padded batch [b, t'] (t' the
    op's time axis): {"fwd", "bwd"}."""
    d, h = cfg["d_model"], cfg["n_heads"]
    e = DTYPE_BYTES[cfg["compute_dtype"]]
    act = b * t * d * e                         # q, k, v, out, or a gradient
    pos = (2 * t - 1) * d * e
    bias = 2 * d * F32
    lse = b * h * t * F32
    fwd = 3 * act + pos + bias + act + lse                  # in; out, lse
    bwd = (4 * act + act + pos + bias + lse                 # q k v out dout
           + 3 * act + pos + bias)                          # dq dk dv dp du dv
    return {"fwd": float(fwd), "bwd": float(bwd)}


def attention_bounds(cfg: Dict, lengths, t_pad: int) -> Dict[str, float]:
    """Least seconds of a step's attention ops, all layers: {"fwd",
    "bwd"}, each max(FLOPs / peak, bytes / bandwidth) a layer."""
    lengths = np.asarray(lengths, dtype=np.int64)
    t = subsampled(t_pad)
    by = attention_bytes(cfg, len(lengths), t)
    fl = attention_flops(cfg, lengths) / cfg["n_layers"]
    out = {}
    for part, mult in (("fwd", 1.0), ("bwd", 2.0)):
        out[part] = cfg["n_layers"] * max(mult * fl / H100_BF16_FLOPS,
                                          by[part] / H100_HBM_BYTES_PER_S)
    return out
