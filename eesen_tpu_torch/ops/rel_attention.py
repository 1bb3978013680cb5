"""Relative-position multi-head attention (Transformer-XL, as the Conformer
uses it) as two ops of the port's own: `eesen_torch::rel_pos_attention`
and its backward `eesen_torch::rel_pos_attention_bwd`, registered with
`torch.library.custom_op` and joined by `register_autograd`.  Each call
is one named host operation in a `torch.profiler` trace, so the device
time of whatever runs inside can be read against the mechanism's cost
(benchmark/metrics/conformer_costs.py); a fused kernel later replaces
the bodies and keeps the ops.

Per batch row b and head h, with q, k, v [B, H, T, dk], the projected
relative positions p [H, 2T-1, dk] (row j is relative position T-1-j,
from T-1 down to -(T-1)) and the learned biases u, v_bias [H, dk]:

    ac[i, k] = (q_i + u) . k_k
    bd[i, k] = (q_i + v_bias) . p_{T-1-i+k}      (relative position i-k)
    s = (ac + bd) / sqrt(dk), -10000 at keys k >= length[b]
    out = softmax(s) v,  lse = logsumexp(s)

`bd` is NeMo's `rel_shift` of the [T, 2T-1] product, taken here as a
strided view (row i starts at column T-1-i) rather than by its pad and
reshape; p gets one zero row, so that the product's rows are 2T wide
(an odd width takes the library's unaligned products).  The forward
saves only its inputs, `out` and `lse`; the backward recomputes the
scores.  Products take their operands in q's dtype (the configuration's
compute dtype) and accumulate in f32; the products whose results the
op works on further give them in f32 (ops/products.mm32), so the
scores, the softmax, their gradients and the bias gradients are f32.
`out`, dq, dk, dv and dp are returned in their inputs' dtype: each is
the operand of a product next, which rounds it so.  Plain torch operations
inside, so both ops run on the CPU too.

`fwd_calls` / `bwd_calls` count the calls (utils/stages.kernel_launches
reads them as `rel_attention_fwd` / `rel_attention_bwd`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from eesen_tpu_torch.ops.products import mm32

MASKED = -10000.0       # NeMo's score at a padded key

# op calls since import (utils/stages.kernel_launches)
fwd_calls = 0
bwd_calls = 0


def _shifted(x: torch.Tensor, t: int) -> torch.Tensor:
    """The [B, H, T, T] view of a contiguous [B, H, T, P] array (P >=
    2T-1) whose (i, k) element is x[..., i, T-1-i+k]."""
    b, h, _, p = x.shape
    return x.as_strided((b, h, t, t), (h * t * p, t * p, p - 1, 1),
                        x.storage_offset() + t - 1)


def _even(p: torch.Tensor) -> torch.Tensor:
    """p [H, 2T-1, dk] with a zero row appended: [H, 2T, dk]."""
    return torch.nn.functional.pad(p, (0, 0, 0, 1))


def _scores(q, k, p, bias_u, bias_v, lengths):
    """(s [B, H, T, T] f32 with the key mask, q+u, q+v in q's dtype);
    p is [H, 2T, dk]."""
    b, h, t, dk = q.shape
    qf = q.float()
    qu = (qf + bias_u[:, None]).to(q.dtype)
    qv = (qf + bias_v[:, None]).to(q.dtype)
    s = mm32(qu, k.transpose(-2, -1))
    bd = mm32(qv, p.expand(b, *p.shape).transpose(-2, -1))  # [B, H, T, 2T]
    s += _shifted(bd, t)
    s *= 1.0 / math.sqrt(dk)
    pad = torch.arange(t, device=q.device)[None, :] >= lengths[:, None]
    s.masked_fill_(pad[:, None, None, :], MASKED)
    return s, qu, qv


@torch.library.custom_op("eesen_torch::rel_pos_attention", mutates_args=())
def rel_pos_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
    bias_u: torch.Tensor, bias_v: torch.Tensor, lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, T, dk] in q's dtype, lse [B, H, T] f32)."""
    global fwd_calls
    fwd_calls += 1
    s, _, _ = _scores(q, k, _even(p), bias_u, bias_v, lengths)
    lse = torch.logsumexp(s, dim=-1)
    a = torch.exp(s.sub_(lse[..., None]))
    return torch.matmul(a.to(v.dtype), v), lse


@torch.library.custom_op("eesen_torch::rel_pos_attention_bwd",
                         mutates_args=())
def rel_pos_attention_bwd(
    grad_out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
    v: torch.Tensor, p: torch.Tensor, bias_u: torch.Tensor,
    bias_v: torch.Tensor, lengths: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor]:
    """(dq, dk, dv, dp in their inputs' dtypes, du, dv_bias f32)."""
    global bwd_calls
    bwd_calls += 1
    cdt = q.dtype
    b, h, t, dk = q.shape
    pe = _even(p)
    s, qu, qv = _scores(q, k, pe, bias_u, bias_v, lengths)
    a = torch.exp(s.sub_(lse[..., None]))
    g = grad_out.to(cdt)
    dv = torch.matmul(a.to(cdt).transpose(-2, -1), g)
    da = mm32(g, v.transpose(-2, -1))
    rows = (grad_out.float() * out.float()).sum(-1, keepdim=True)
    ds = (a.mul_(da.sub_(rows)) * (1.0 / math.sqrt(dk))).to(cdt)
    dqu = mm32(ds, k)
    dk_ = torch.matmul(ds.transpose(-2, -1), qu)
    dbd = torch.zeros((b, h, t, 2 * t), dtype=cdt, device=q.device)
    _shifted(dbd, t).copy_(ds)
    dqv = mm32(dbd, pe.expand(b, *pe.shape))
    dp = mm32(dbd.transpose(-2, -1), qv).sum(0)
    return ((dqu + dqv).to(cdt), dk_, dv,
            dp[:, :2 * t - 1].to(p.dtype).contiguous(),
            dqu.sum((0, 2)), dqv.sum((0, 2)))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs, *output)


def _backward(ctx, grad_out, _grad_lse):
    q, k, v, p, bias_u, bias_v, lengths, out, lse = ctx.saved_tensors
    dq, dk, dv, dp, du, dvb = rel_pos_attention_bwd(
        grad_out, q, k, v, p, bias_u, bias_v, lengths, out, lse)
    return dq, dk, dv, dp, du, dvb, None


torch.library.register_autograd("eesen_torch::rel_pos_attention",
                                _backward, setup_context=_setup_context)
