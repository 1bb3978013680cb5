"""CTC loss in PyTorch (counterpart of eesen_tpu/ops/ctc.py).

The reference's CTC objective (src/net/ctc-loss.cc:101-195; the CUDA
kernels src/gpucompute/cuda-kernels.cu:1332-1664): labels are expanded
with interleaved blanks to the 2L+1 state lattice, the alpha/beta
recursions run in log space, and the gradient with respect to the
pre-softmax logits is the reference's softmax-composed one,
softmax - gamma (src/net/ctc-loss.cc:156-167).

The recursions run through `ops/ctc_cuda.ctc_alpha_beta`: the CUDA kernels
on a CUDA tensor, their plain version on a CPU tensor (the JAX package's
`EESEN_CTC_PALLAS` switch is gone; the tensor's device decides).  The
gamma -> vocabulary scatter of the backward pass stays in torch, as the
JAX package keeps it in XLA.  `ctc_forward_backward` keeps the JAX
package's XLA-scan formulation as a plain function.

A padded batch row (frames 0, labels 0) gets an NLL of -log p(blank |
frame 0) and a zero gradient, exactly as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eesen_tpu_torch.ops.ctc_cuda import ctc_alpha_beta
from eesen_tpu_torch.utils.math import (
    LOG_ZERO, LOG_ZERO_THRESHOLD, log_add, shift_left, shift_right,
)


def expand_labels(labels: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """[l1..lL] (padded) -> [blank, l1, blank, l2, ..., blank]: [B, L] ->
    [B, 2L+1] (reference: src/net/ctc-loss.cc:117-131).  Padding positions
    hold blank; `label_lengths` masks them out of the recursion."""
    b, l = labels.shape
    exp = torch.full((b, 2 * l + 1), blank_id, dtype=labels.dtype,
                     device=labels.device)
    exp[:, 1::2] = labels
    return exp


def _final_states(
    label_lengths: torch.Tensor, s_max: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(last_blank [B], last_label [B], beta_init_row [B, S]): 0 at the
    final blank and, for rows with labels, the final label state."""
    s_iota = torch.arange(s_max, device=label_lengths.device)[None, :]
    last_blank = 2 * label_lengths
    last_label = torch.clamp(2 * label_lengths - 1, min=0)
    is_final = (s_iota == last_blank[:, None]) | (
        (s_iota == last_label[:, None]) & (label_lengths[:, None] > 0)
    )
    return last_blank, last_label, torch.where(is_final, 0.0, LOG_ZERO)


def _loglik(alpha, last_blank, last_label, label_lengths) -> torch.Tensor:
    """log p: log_add of the final blank and final label states at the
    last frame (alpha is frozen past each row's end)."""
    a_fin = alpha[:, -1, :]
    fin_b = a_fin.gather(1, last_blank[:, None].long())[:, 0]
    fin_l = a_fin.gather(1, last_label[:, None].long())[:, 0]
    fin_l = torch.where(label_lengths > 0, fin_l, LOG_ZERO)
    return log_add(fin_b, fin_l)


def ctc_forward_backward(
    log_probs_e: torch.Tensor,
    can_skip: torch.Tensor,
    logit_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recursions in the JAX package's XLA-scan form (ctc.py:68-156):
    log_probs_e [B, T, S], can_skip [B, S] bool, lengths [B] ->
    (loglik [B], alpha [B, T, S], beta [B, T, S])."""
    bsz, t_max, s_max = log_probs_e.shape
    dev = log_probs_e.device
    logit_lengths = logit_lengths.to(dev)
    label_lengths = label_lengths.to(dev)
    can_skip_f = torch.where(can_skip, 0.0, LOG_ZERO)
    s_iota = torch.arange(s_max, device=dev)[None, :]
    a = torch.where(s_iota <= 1, log_probs_e[:, 0, :], LOG_ZERO)
    # sequences with zero labels may only start in the single blank state
    a = torch.where((label_lengths[:, None] == 0) & (s_iota > 0), LOG_ZERO, a)
    alphas = [a]
    for t in range(1, t_max):
        prev1 = shift_right(a, 1)
        prev2 = shift_right(a, 2) + can_skip_f
        a_new = log_probs_e[:, t] + log_add(log_add(a, prev1), prev2)
        a = torch.where((t < logit_lengths)[:, None], a_new, a)
        alphas.append(a)
    alpha = torch.stack(alphas, dim=1)

    last_blank, last_label, beta_init_row = _final_states(label_lengths,
                                                          s_max)
    loglik = _loglik(alpha, last_blank, last_label, label_lengths)

    skip2 = shift_left(can_skip_f, 2)
    b = torch.full((bsz, s_max), LOG_ZERO, dtype=log_probs_e.dtype,
                   device=dev)
    betas = []
    for t in range(t_max - 1, -1, -1):
        nxt = b + log_probs_e[:, min(t + 1, t_max - 1)]
        b_new = log_add(log_add(nxt, shift_left(nxt, 1)),
                        shift_left(nxt, 2) + skip2)
        at_init = (t == logit_lengths - 1)[:, None]
        before_end = (t < logit_lengths - 1)[:, None]
        b = torch.where(at_init, beta_init_row,
                        torch.where(before_end, b_new, LOG_ZERO))
        betas.append(b)
    beta = torch.stack(betas[::-1], dim=1)
    return loglik, alpha, beta


def _ctc_prep(logits, labels, label_lengths, blank_id):
    """(log_probs [B,T,V], elab [B,S], can_skip [B,S], valid_s [B,S],
    lp_e [B,T,S]) as in the JAX package's `_ctc_prep`."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    elab = expand_labels(labels.to(torch.int64), blank_id)
    b, s = elab.shape
    s_iota = torch.arange(s, device=elab.device)[None, :]
    is_label = (s_iota % 2) == 1
    prev2_lab = shift_right(elab.to(torch.float32), 2, -1.0).to(torch.int64)
    can_skip = is_label & (elab != prev2_lab) & (s_iota >= 2)
    # restrict to valid expanded positions (s < 2*label_len+1)
    valid_s = s_iota < (2 * label_lengths[:, None] + 1)
    lp_e = log_probs.gather(2, elab[:, None, :].expand(b, logits.shape[1], s))
    lp_e = torch.where(valid_s[:, None, :], lp_e, LOG_ZERO)
    return log_probs, elab, can_skip, valid_s, lp_e


def _ctc_bwd(log_probs, elab, valid_s, alpha, beta, loglik, logit_lengths,
             g) -> torch.Tensor:
    """d(g . nll)/d(logits) = (softmax - gamma) * g, zero past each row's
    frames (ctc.py:279-299)."""
    b, t_max, v = log_probs.shape
    log_gamma = alpha + beta - loglik[:, None, None]
    log_gamma = torch.where(valid_s[:, None, :], log_gamma, LOG_ZERO)
    gamma = torch.where(
        log_gamma > LOG_ZERO_THRESHOLD,
        torch.exp(torch.clamp(log_gamma, max=0.0)), 0.0,
    )
    # state posteriors onto the vocabulary: a one-hot contraction, as the
    # JAX package does it (a deterministic sum order, unlike scatter_add)
    onehot = torch.nn.functional.one_hot(elab, v).to(gamma.dtype)  # [B,S,V]
    gamma_v = torch.bmm(gamma, onehot)
    grad = torch.exp(log_probs) - gamma_v
    time_mask = (torch.arange(t_max, device=log_probs.device)[None, :]
                 < logit_lengths[:, None])
    grad = grad * time_mask[:, :, None]
    return grad * g[:, None, None]


class CtcLoss(torch.autograd.Function):
    """Per-sequence NLL with the Eesen-composed gradient."""

    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths, blank_id):
        logit_lengths = logit_lengths.to(logits.device)
        label_lengths = label_lengths.to(logits.device)
        log_probs, elab, can_skip, valid_s, lp_e = _ctc_prep(
            logits, labels.to(logits.device), label_lengths, blank_id
        )
        _, _, s_max = lp_e.shape
        last_blank, last_label, beta_init_row = _final_states(label_lengths,
                                                              s_max)
        alpha, beta = ctc_alpha_beta(
            lp_e.contiguous(),
            torch.where(can_skip, 0.0, LOG_ZERO).contiguous(),
            beta_init_row.contiguous(), logit_lengths,
        )
        loglik = _loglik(alpha, last_blank, last_label, label_lengths)
        ctx.save_for_backward(log_probs, elab, valid_s, alpha, beta, loglik,
                              logit_lengths)
        return -loglik

    @staticmethod
    def backward(ctx, g):
        grad = _ctc_bwd(*ctx.saved_tensors, g)
        return grad, None, None, None, None


def ctc_loss(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = 0,
) -> torch.Tensor:
    """-log p(labels | logits) per sequence: logits [B, T, V] pre-softmax,
    logit_lengths [B], labels [B, L] padded, label_lengths [B] -> [B]
    float32.  Its gradient is softmax - gamma (ctc.py:279-299)."""
    return CtcLoss.apply(logits, logit_lengths, labels, label_lengths,
                         blank_id)


def ctc_loss_mean(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = 0,
    normalize: str = "frames",
) -> torch.Tensor:
    """Sum of per-sequence NLL / (total frames | sequences | 1);
    "frames" is the reference's per-frame objective (ctc-loss.cc:180-194)."""
    nll = ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id)
    if normalize == "frames":
        denom = torch.clamp(logit_lengths.sum(), min=1).to(nll.dtype)
    elif normalize == "sequences":
        denom = torch.tensor(float(nll.shape[0]), dtype=nll.dtype)
    else:
        denom = torch.tensor(1.0, dtype=nll.dtype)
    return nll.sum() / denom.to(nll.device)
