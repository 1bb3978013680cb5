"""Plain reference of Conformer-CTC training steps (NVIDIA NeMo's
Conformer-CTC: `ConvSubsampling` "striding", `RelPositionalEncoding`,
`ConformerLayer` with `RelPositionMultiHeadAttention` and
`ConformerConvolution`, `ConvASRDecoder`), in float32 torch operations
with TF32 off, gradients by autograd, and AdamW.

    x = relu(conv2d(relu(conv2d(feats))))       3x3, stride 2, padding 1
    x = Linear(C * F' -> d)(x) * sqrt(d)
    pos = sinusoids of T'-1 ... -(T'-1)          (sine even, cosine odd)
    per layer:
        x = x + FFN1(LN(x)) / 2     FFN = W2 swish(W1 y + b1) + b2
        x = x + MHSA(LN(x))
        x = x + Conv(LN(x))         PW2 swish(BN(DW(mask GLU(PW1 y))))
        x = x + FFN2(LN(x)) / 2
        x = LN(x)
    logits = W_out x + b_out;  loss = sum of CTC NLL / sum of T' lengths

MHSA per head: ac = (q + u) k^T; bd = rel_shift((q + v) p^T) cut to T'
columns, with NeMo's rel_shift written out (pad one zero column on the
left, view as [2T', T'], drop the first row, view back); scores = (ac +
bd) / sqrt(d_k), -10000 at keys past the row's length; softmax; times V;
W_out.  BatchNorm in training: the mean and the biased variance over
every position of the padded batch normalize; the running mean and the
unbiased variance move by momentum 0.1 (nn.BatchNorm1d); the count adds
one.  The lengths: each convolution takes n to floor((n + 1) / 2).
CTC: `F.ctc_loss` on the f32 log-softmax, blank 0.  AdamW: m, v with
bias correction, p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p).

Departures from NeMo: no dropout, no SpecAugment, a fixed learning rate
(no Noam schedule), the features given directly (no preprocessor), blank
at index 0 (NeMo's is the last), and the padded query rows not zeroed
after the softmax (NeMo's mask zeroes them; here only the keys are
masked, so padded positions carry other values into BatchNorm's
statistics).

Parameters are the port's tree (weights [out, in, ...]):
`subsample/{conv1,conv2}/{w,b}`, `subsample/out/{w,b}`, `layers/[i]/`
`ff1|ff2/{norm/{gamma,beta}, in, out}`, `att/{norm, q, k, v, out,
pos/w, pos_u, pos_v}`, `conv/{norm, pw1, dw/{w [d, K], b}, bn/{gamma,
beta}, pw2}`, `norm_out`, then `out/{w,b}`; `buffers` a list of
`{mean, var, count}` a layer.

`prec` rounds every product's operands ("f32": none; "bf16"; "fp8": e4m3
under one scale per matrix, as reference/quant.py) in the forward pass,
the gradient passing straight through.  `checkpoint` recomputes the
subsampling and each layer in the backward pass (torch.utils.checkpoint)
so that full-size batches fit; BatchNorm's statistics are those of the
whole batch either way, and its buffers move once a step.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

LN_EPS = 1e-5
BN_EPS = 1e-5
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    """x with its value rounded to `prec` and its gradient passed on."""
    if prec == "f32":
        return x
    if prec == "bf16":
        q = x.detach().to(torch.bfloat16).to(torch.float32)
    elif prec == "fp8":
        y = x.detach()
        if y.dim() < 2:
            y = y[None]
        scale = y.abs().amax(dim=(-2, -1), keepdim=True).clamp(
            min=1e-30) / FP8_MAX
        q = ((y / scale).to(torch.float8_e4m3fn).to(torch.float32)
             * scale).reshape(x.shape)
    else:
        raise ValueError(f"unknown precision {prec}")
    return x + (q - x.detach())


def out_lengths(lengths):
    return ((lengths + 1) // 2 + 1) // 2


# ---------------------------------------------------------------- blocks

def _linear(x, p, prec):
    return torch.matmul(_round(x, prec), _round(p["w"], prec).t()) + p["b"]


def _layer_norm(x, p):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * p["gamma"] + p["beta"]


def _swish(x):
    return x * torch.sigmoid(x)


def _ffn(p, x, prec):
    return _linear(_swish(_linear(_layer_norm(x, p["norm"]), p["in"], prec)),
                   p["out"], prec)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """NeMo's RelPositionMultiHeadAttention.rel_shift: [B, H, T, 2T-1]."""
    b, h, t, n = x.shape
    x = F.pad(x, (1, 0))
    x = x.view(b, h, n + 1, t)[:, :, 1:]
    return x.reshape(b, h, t, n)


def positions(t: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float32,
                       device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros(2 * t - 1, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _attention(p, x, pos, key_pad, n_heads, prec):
    b, t, d = x.shape
    dk = d // n_heads
    y = _layer_norm(x, p["norm"])
    split = lambda z: z.view(b, -1, n_heads, dk).transpose(1, 2)
    q = split(_linear(y, p["q"], prec))
    k = split(_linear(y, p["k"], prec))
    v = split(_linear(y, p["v"], prec))
    pp = torch.matmul(_round(pos, prec), _round(p["pos"]["w"], prec).t())
    pp = pp.view(1, -1, n_heads, dk).transpose(1, 2)       # [1, H, 2T-1, dk]
    qu = q + p["pos_u"][None, :, None, :]
    qv = q + p["pos_v"][None, :, None, :]
    ac = torch.matmul(_round(qu, prec), _round(k, prec).transpose(-2, -1))
    bd = torch.matmul(_round(qv, prec), _round(pp, prec).transpose(-2, -1))
    bd = rel_shift(bd)[:, :, :, :t]
    scores = (ac + bd) / math.sqrt(dk)
    scores = scores.masked_fill(key_pad[:, None, None, :], -10000.0)
    att = torch.softmax(scores, dim=-1)
    out = torch.matmul(_round(att, prec), _round(v, prec))
    return _linear(out.transpose(1, 2).reshape(b, t, d), p["out"], prec)


def _conv(p, x, pad, prec):
    """(the module's output, the batch mean and unbiased variance)."""
    y = _linear(_layer_norm(x, p["norm"]), p["pw1"], prec)
    a, g = y.chunk(2, dim=-1)
    y = (a * torch.sigmoid(g)).masked_fill(pad[..., None], 0.0)
    y = y.transpose(1, 2)                                  # [B, d, T]
    k = p["dw"]["w"].shape[1]
    y = F.conv1d(_round(y, prec), _round(p["dw"]["w"], prec)[:, None, :],
                 p["dw"]["b"], padding=(k - 1) // 2, groups=y.shape[1])
    n = y.shape[0] * y.shape[2]
    mean = y.mean((0, 2))
    var = ((y - mean[None, :, None]) ** 2).mean((0, 2))
    y = (y - mean[None, :, None]) / torch.sqrt(var[None, :, None] + BN_EPS)
    y = y * p["bn"]["gamma"][None, :, None] + p["bn"]["beta"][None, :, None]
    out = _linear(_swish(y).transpose(1, 2), p["pw2"], prec)
    return out, mean.detach(), (var * n / max(n - 1, 1)).detach()


def _layer(lp, x, pos, pad, n_heads, prec):
    x = x + 0.5 * _ffn(lp["ff1"], x, prec)
    x = x + _attention(lp["att"], x, pos, pad, n_heads, prec)
    y, mean, var = _conv(lp["conv"], x, pad, prec)
    x = x + y
    x = x + 0.5 * _ffn(lp["ff2"], x, prec)
    return _layer_norm(x, lp["norm_out"]), mean, var


def _subsample(p, feats, prec):
    x = feats[:, None]
    for name in ("conv1", "conv2"):
        x = torch.relu(F.conv2d(_round(x, prec), _round(p[name]["w"], prec),
                                p[name]["b"], stride=2, padding=1))
    b, c, t, f = x.shape
    return _linear(x.transpose(1, 2).reshape(b, t, c * f), p["out"], prec)


def forward(params, feats, lengths, cfg: Dict, prec: str = "f32",
            checkpoint: bool = False):
    """(logits [B, T', V], T' lengths [B], buffers after a training step)
    of the training forward pass."""
    run = ((lambda f, *a: _checkpoint(f, *a, use_reentrant=False))
           if checkpoint else (lambda f, *a: f(*a)))
    d, n_heads = cfg["d_model"], cfg["n_heads"]
    x = run(lambda f: _subsample(params["subsample"], f, prec), feats)
    if cfg["xscaling"]:
        x = x * math.sqrt(d)
    t = x.shape[1]
    lens = out_lengths(lengths)
    pad = torch.arange(t, device=x.device)[None, :] >= lens[:, None]
    pos = positions(t, d, x.device)
    m = cfg["bn_momentum"]
    buffers = []
    for lp, buf in zip(params["layers"], params["buffers"]):
        x, mean, var = run(
            lambda z, lp=lp: _layer(lp, z, pos, pad, n_heads, prec), x)
        buffers.append({"mean": (1 - m) * buf["mean"] + m * mean,
                        "var": (1 - m) * buf["var"] + m * var,
                        "count": buf["count"] + 1})
    return _linear(x, params["out"], prec), lens, buffers


# ------------------------------------------------------------ the steps

def leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every trained leaf, dict keys sorted, lists in
    order, nothing under `buffers`."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, t) for k in sorted(tree)
                if k != "buffers" for p, t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}" if p else str(i), t) for i, v in enumerate(tree)
                for p, t in leaves(v)]
    return [("", tree)]


def tree_map(fn, *trees):
    """fn over the trained leaves in `leaves` order; `buffers` from the
    first tree as is."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: (tree_map(fn, *(t[k] for t in trees)) if k != "buffers"
                    else t0[k]) for k in sorted(t0)}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def loss_and_grads(params, batch, cfg: Dict, prec: str = "f32",
                   checkpoint: bool = False):
    """(loss, grads tree, buffers after the step) of one batch: loss =
    sum of the rows' CTC NLL / sum of their T' lengths."""
    ps = [t.detach().requires_grad_() for _, t in leaves(params)]
    it = iter(ps)
    live = tree_map(lambda _: next(it), params)
    logits, lens, buffers = forward(live, batch["feats"],
                                    batch["feat_lengths"].long(), cfg, prec,
                                    checkpoint)
    lp = torch.log_softmax(logits, dim=-1).transpose(0, 1)
    nll = F.ctc_loss(lp, batch["labels"].long(), lens,
                     batch["label_lengths"].long(), blank=0,
                     reduction="none")
    loss = nll.sum() / lens.sum().clamp(min=1)
    it = iter(torch.autograd.grad(loss, ps))
    return (loss.detach(), tree_map(lambda _: next(it), params),
            [{k: v.detach() for k, v in b.items()} for b in buffers])


class AdamW:
    """torch.optim.AdamW's update, leaf by leaf."""

    def __init__(self, opt: Dict):
        self.b1, self.b2 = opt["b1"], opt["b2"]
        self.eps, self.wd, self.lr = opt["eps"], opt["weight_decay"], \
            opt["learn_rate"]
        self.m = self.v = None
        self.t = 0

    def step(self, params, grads):
        self.t += 1
        if self.m is None:
            self.m = tree_map(torch.zeros_like, params)
            self.v = tree_map(torch.zeros_like, params)
        self.m = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g,
                          self.m, grads)
        self.v = tree_map(lambda v, g: self.b2 * v + (1 - self.b2) * g * g,
                          self.v, grads)
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        return tree_map(
            lambda p, m, v: p - self.lr * ((m / c1) / (torch.sqrt(v / c2)
                                                       + self.eps)
                                           + self.wd * p),
            params, self.m, self.v)


def follow(params0, batches, cfg: Dict, prec: str = "f32",
           checkpoint: bool = False):
    """The first len(batches) steps from params0: (losses, AdamW's first
    moment after step 1 over (1 - b1), the parameters after the last step
    with their buffers)."""
    opt = AdamW(cfg["optimizer"])
    params = params0
    losses, g1 = [], None
    for batch in batches:
        loss, grads, buffers = loss_and_grads(params, batch, cfg, prec,
                                              checkpoint)
        losses.append(float(loss))
        params = {**opt.step(params, grads), "buffers": buffers}
        if g1 is None:
            g1 = tree_map(lambda m: m / (1 - opt.b1), opt.m)
        del grads
    return losses, g1, params
