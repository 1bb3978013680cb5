"""Conformer-CTC acoustic model (Gulati et al., Interspeech 2020; NVIDIA
NeMo's `ConformerEncoder` + `ConvASRDecoder`, as in
examples/asr/conf/conformer/conformer_ctc_bpe.yaml).

    x = relu(conv2d_2(relu(conv2d_1(feats))))        3x3, stride 2, twice
    x = Linear(C * F/4 -> d)(x) * sqrt(d)            (xscaling)
    per layer, with LN a LayerNorm:
        x = x + 1/2 FFN1(LN(x))       FFN(y) = W2 swish(W1 y + b1) + b2
        x = x + MHSA_relpos(LN(x), pos)                ops/rel_attention.py
        x = x + Conv(LN(x))  Conv(y) = PW2 swish(BN(DW_k(mask GLU(PW1 y))))
        x = x + 1/2 FFN2(LN(x))
        x = LN_out(x)
    logits = Conv1d_k=1(d -> V)(x)

The subsampling takes a length L to floor((L+1)/2) twice
(`output_lengths`), and CTC runs on those frames.  The relative
positions are the sinusoids of T'-1 down to -(T'-1) (NeMo's
RelPositionalEncoding), projected per layer without bias (`att/pos`);
u and v are the layer's own (`untie_biases`).  The attention's keys past
a row's length are masked; the depthwise convolution's input is zeroed
past it.  BatchNorm uses the batch's statistics over every position of
the padded batch in training and the running ones in evaluation.

Parameters are a plain dict of tensors, weights in torch's [out, in]
layout: `subsample/{conv1,conv2,out}`, `layers/[i]/{ff1, att, conv,
ff2, norm_out}`, `out`.  BatchNorm's running mean, variance and count,
which no gradient reaches, sit under the key `buffers` (a list, one
`{mean, var, count}` a layer); the trainer keeps that key from the
gradients and the optimizer (`training/trainer.trained`), while
checkpoints, which save the whole tree, keep it.  A training forward
returns the updated buffers through `buffers_out` and leaves the given
ones as they were.

Products take their operands in `compute_dtype`, accumulate in f32 and
give f32 results, their gradients too (ops/products.py); the depthwise
convolution runs in f32 on operands rounded to `compute_dtype`.  The
two subsampling convolutions are the library's in `compute_dtype`,
whose results are rounded to it: after the ReLU each is the operand of
the next product, which would round it the same way, but their
gradients pass in `compute_dtype`.  LayerNorm, BatchNorm, the softmax,
the elementwise work and the residual stream are f32.  The spans
`model.subsample`, `conformer.ffn` (twice a layer),
`conformer.attention` and `conformer.conv` time each block's forward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from eesen_tpu_torch.ops.products import linear32, rounded
from eesen_tpu_torch.ops.rel_attention import rel_pos_attention
from eesen_tpu_torch.utils.profile import profiler

Params = Dict[str, Any]
BUFFERS = "buffers"
LN_EPS = 1e-5
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    """Defaults are NeMo's Conformer-CTC Large (conformer_ctc_bpe.yaml):
    `striding` x4 subsampling with d_model channels, 18 layers of width
    512, 8 heads, feed-forward x4, rel_pos attention with untied biases
    and xscaling, a depthwise kernel of 31 with batch_norm; 80-dim
    features; 128 tokens + blank (id 0)."""

    input_dim: int = 80
    d_model: int = 512
    n_layers: int = 18
    n_heads: int = 8
    ff_expansion_factor: int = 4
    conv_kernel_size: int = 31
    subsampling_conv_channels: int = 512
    xscaling: bool = True
    pos_emb_max_len: int = 5000
    num_targets: int = 129          # vocabulary incl. blank at index 0
    bn_momentum: float = 0.1
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def subsampled_dim(self) -> int:
        """The feature axis after the two stride-2 convolutions."""
        return output_lengths(self.input_dim)


def output_lengths(lengths):
    """Frames after the x4 subsampling (NeMo's calc_length): each 3x3
    stride-2 convolution with padding 1 takes n to floor((n+1)/2).  A
    tensor, a numpy array or an int."""
    return ((lengths + 1) // 2 + 1) // 2


def refuse(cfg, path: str) -> None:
    """Raise for a path that does not take a Conformer yet."""
    if isinstance(cfg, ConformerConfig):
        raise NotImplementedError(f"{path} does not take a Conformer "
                                  "configuration yet")


# ------------------------------------------------------------ parameters

def _ln(d):
    return {"gamma": ("one", (d,)), "beta": ("zero", (d,))}


def _lin(n_out, n_in):
    return {"w": ("w", (n_out, n_in)), "b": ("b", (n_out,))}


def param_shapes(cfg: ConformerConfig) -> Params:
    """The parameter tree as (init kind, shape) leaves; `buffers` last."""
    d, c, h = cfg.d_model, cfg.subsampling_conv_channels, cfg.n_heads
    ff = cfg.ff_expansion_factor * d

    def ffn():
        return {"norm": _ln(d), "in": _lin(ff, d), "out": _lin(d, ff)}

    layer = {
        "ff1": ffn(),
        "att": {"norm": _ln(d), "q": _lin(d, d), "k": _lin(d, d),
                "v": _lin(d, d), "out": _lin(d, d),
                "pos": {"w": ("w", (d, d))},
                "pos_u": ("u", (h, d // h)), "pos_v": ("u", (h, d // h))},
        "conv": {"norm": _ln(d), "pw1": _lin(2 * d, d),
                 "dw": {"w": ("w", (d, cfg.conv_kernel_size)),
                        "b": ("b", (d,))},
                 "bn": _ln(d), "pw2": _lin(d, d)},
        "ff2": ffn(),
        "norm_out": _ln(d),
    }
    return {
        "subsample": {
            "conv1": {"w": ("w", (c, 1, 3, 3)), "b": ("b", (c,))},
            "conv2": {"w": ("w", (c, c, 3, 3)), "b": ("b", (c,))},
            "out": _lin(d, c * cfg.subsampled_dim),
        },
        "layers": [layer] * cfg.n_layers,
        "out": _lin(cfg.num_targets, d),
        BUFFERS: [{"mean": ("zero", (d,)), "var": ("one", (d,)),
                   "count": ("count", ())}] * cfg.n_layers,
    }


def init_conformer(gen: torch.Generator, cfg: ConformerConfig,
                   device) -> Params:
    """Parameters drawn from `gen` (on its own device), placed on
    `device`: each weight and its bias uniform in +-1/sqrt(fan-in) (the
    fan-in of a weight [out, in, ...] is the product of all but its first
    axis; the depthwise kernel's is its width), u and v uniform in
    +-1/sqrt(d_k), LayerNorm and BatchNorm at gamma 1, beta 0, running
    statistics 0 and 1, count 0."""
    dk = cfg.d_model // cfg.n_heads

    def draw(shape, bound):
        x = torch.rand(shape, generator=gen, device=gen.device)
        return ((x * 2.0 - 1.0) * bound).to(device)

    def build(node, bound=None):
        if isinstance(node, list):
            return [build(v) for v in node]
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, tuple):
                fan = math.prod(w[1][1:])
                bound = 1.0 / math.sqrt(fan)
            return {k: build(v, bound) for k, v in node.items()}
        kind, shape = node
        if kind in ("w", "b"):
            return draw(shape, bound)
        if kind == "u":
            return draw(shape, 1.0 / math.sqrt(dk))
        if kind == "count":
            return torch.zeros(shape, dtype=torch.int64, device=device)
        fill = 1.0 if kind == "one" else 0.0
        return torch.full(shape, fill, dtype=torch.float32, device=device)

    return build(param_shapes(cfg))


# --------------------------------------------------------------- forward

def _linear(x, p, cdt):
    """x W^T + b: the product of `cdt` operands into f32, the bias added
    in f32."""
    return linear32(x, p["w"], cdt) + p["b"]


def _norm(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["gamma"], p["beta"], LN_EPS)


def rel_positions(t: int, d: int, device) -> torch.Tensor:
    """[2T-1, d] f32: sinusoids of positions T-1 down to -(T-1), sine in
    the even columns, cosine in the odd ones."""
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float32,
                       device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.empty((2 * t - 1, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def subsample(p, feats, cfg: ConformerConfig) -> torch.Tensor:
    """feats [B, T, F] -> [B, T', d] f32."""
    cdt = cfg.compute_dtype
    x = feats[:, None].to(cdt)
    for name in ("conv1", "conv2"):
        x = F.relu(F.conv2d(x, p[name]["w"].to(cdt), p[name]["b"].to(cdt),
                            stride=2, padding=1))
    b, c, t, f = x.shape
    return _linear(x.transpose(1, 2).reshape(b, t, c * f), p["out"], cdt)


def _ffn(p, x, cdt):
    with profiler.track("conformer.ffn"):
        h = F.silu(_linear(_norm(x, p["norm"]), p["in"], cdt))
        return _linear(h, p["out"], cdt)


def _attention(p, x, pos, lengths, cfg):
    with profiler.track("conformer.attention"):
        cdt = cfg.compute_dtype
        b, t, d = x.shape
        h = cfg.n_heads
        y = _norm(x, p["norm"])

        def heads(name):
            return _linear(y, p[name], cdt).to(cdt).view(
                b, t, h, d // h).transpose(1, 2).contiguous()

        pp = linear32(pos, p["pos"]["w"], cdt).to(cdt)
        pp = pp.view(-1, h, d // h).transpose(0, 1).contiguous()
        out, _ = rel_pos_attention(heads("q"), heads("k"), heads("v"), pp,
                                   p["pos_u"], p["pos_v"], lengths)
        return _linear(out.transpose(1, 2).reshape(b, t, d), p["out"], cdt)


def _conv(p, buf, x, pad, cfg, train):
    """(the module's output, the layer's buffers after it)."""
    with profiler.track("conformer.conv"):
        cdt = cfg.compute_dtype
        y = F.glu(_linear(_norm(x, p["norm"]), p["pw1"], cdt), dim=-1)
        y = y.masked_fill(pad[..., None], 0.0).transpose(1, 2)
        k = cfg.conv_kernel_size
        y = F.conv1d(rounded(y, cdt), rounded(p["dw"]["w"], cdt)[:, None, :],
                     p["dw"]["b"], padding=(k - 1) // 2, groups=y.shape[1])
        if train:
            buf = {"mean": buf["mean"].clone(), "var": buf["var"].clone(),
                   "count": buf["count"] + 1}
        y = F.batch_norm(y, buf["mean"], buf["var"], p["bn"]["gamma"],
                         p["bn"]["beta"], training=train,
                         momentum=cfg.bn_momentum, eps=BN_EPS)
        return _linear(F.silu(y).transpose(1, 2), p["pw2"], cdt), buf


def apply_conformer(
    params: Params, feats: torch.Tensor, lengths: torch.Tensor,
    cfg: ConformerConfig, *, train: bool = False,
    buffers_out: Optional[Dict[str, List]] = None,
) -> torch.Tensor:
    """feats [B, T, input_dim], lengths [B] -> logits [B, T', V] f32.
    With `train`, BatchNorm normalizes by the batch's statistics and the
    updated running statistics go to `buffers_out[BUFFERS]` (when
    given)."""
    cdt = cfg.compute_dtype
    d = cfg.d_model
    with profiler.track("model.subsample"):
        x = subsample(params["subsample"], feats, cfg)
    if cfg.xscaling:
        x = x * math.sqrt(d)
    t = x.shape[1]
    if t > cfg.pos_emb_max_len:
        raise ValueError(f"{t} frames after subsampling exceed "
                         f"pos_emb_max_len {cfg.pos_emb_max_len}")
    lens = output_lengths(lengths.to(x.device))
    pad = torch.arange(t, device=x.device)[None, :] >= lens[:, None]
    pos = rel_positions(t, d, x.device)
    new_buffers = []
    for lp, buf in zip(params["layers"], params[BUFFERS]):
        x = x + 0.5 * _ffn(lp["ff1"], x, cdt)
        x = x + _attention(lp["att"], x, pos, lens, cfg)
        y, buf = _conv(lp["conv"], buf, x, pad, cfg, train)
        x = x + y
        x = x + 0.5 * _ffn(lp["ff2"], x, cdt)
        x = _norm(x, lp["norm_out"])
        new_buffers.append(buf)
    if train and buffers_out is not None:
        buffers_out[BUFFERS] = new_buffers
    return _linear(x, params["out"], cdt)
