"""CTC forced alignment (Viterbi over the expanded label lattice)
(counterpart of eesen_tpu/ops/align.py).

The reference aligns by composing a transcript FST with the token FST and
decoding (reference: asr_egs/wsj/steps/align_ctc_single_utt.sh +
utils/training_trans_fst.py).  Equivalently, this is the max-product
version of the CTC forward recursion over the 2L+1 expanded-label states,
with backpointers: a loop over frames of torch ops on the device of
`log_probs` (the JAX package's `lax.scan`), then a host traceback.
Produces per-frame label ids (blank = 0), i.e. the same frame alignment
the reference's composed-FST decode yields.  No kernel: the JAX package's
version is XLA code, not Pallas.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from eesen_tpu_torch.models.model import as_tensor
from eesen_tpu_torch.ops.ctc import expand_labels
from eesen_tpu_torch.utils.math import LOG_ZERO, shift_right


def ctc_viterbi(
    log_probs,
    logit_lengths,
    labels,
    label_lengths,
    blank_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-product forward pass.

    log_probs: [B, T, V] log-softmax outputs (a tensor stays on its
    device; host arrays run on the CPU).
    Returns (delta [B, T, S] float32, psi [B, T, S] int8 backpointer
    offsets in {0, 1, 2}), on the device of log_probs."""
    lp = as_tensor(log_probs, torch.float32)
    dev = lp.device
    lens = as_tensor(logit_lengths, torch.int64).to(dev)
    lab_lens = as_tensor(label_lengths, torch.int64).to(dev)
    elab = expand_labels(as_tensor(labels, torch.int64).to(dev), blank_id)
    b, s = elab.shape
    t_max = lp.shape[1]
    s_iota = torch.arange(s, device=dev)[None, :].expand(b, s)
    is_label = (s_iota % 2) == 1
    prev2 = shift_right(elab, 2, -1)
    can_skip = is_label & (elab != prev2) & (s_iota >= 2)
    valid_s = s_iota < (2 * lab_lens[:, None] + 1)

    lp_e = torch.gather(lp, 2, elab[:, None, :].expand(b, t_max, s))
    lp_e = torch.where(valid_s[:, None, :], lp_e, LOG_ZERO)
    neg = torch.tensor(LOG_ZERO, dtype=torch.float32, device=dev)

    delta = torch.where(s_iota <= 1, lp_e[:, 0, :], neg)
    deltas = [delta]
    psis = [torch.zeros((b, s), dtype=torch.int8, device=dev)]
    for t in range(1, t_max):
        c1 = shift_right(delta, 1, LOG_ZERO)
        c2 = torch.where(can_skip, shift_right(delta, 2, LOG_ZERO), neg)
        # max returns the first maximum's index, as jnp.argmax does
        best, arg = torch.stack([delta, c1, c2]).max(dim=0)
        new = lp_e[:, t, :] + best
        active = (t < lens)[:, None]
        delta = torch.where(active, new, delta)
        deltas.append(delta)
        psis.append(arg.to(torch.int8))
    return torch.stack(deltas, dim=1), torch.stack(psis, dim=1)


def ctc_align(
    log_probs,
    logit_lengths,
    labels,
    label_lengths,
    blank_id: int = 0,
) -> List[np.ndarray]:
    """Frame-level forced alignment.

    Returns per-utterance int32 arrays of length logit_length with the
    aligned label id (blank_id at blank frames).  delta and psi come to
    the host once; the traceback is host numpy."""
    delta, psi = ctc_viterbi(
        log_probs, logit_lengths, labels, label_lengths, blank_id
    )
    delta = delta.cpu().numpy()
    psi = psi.cpu().numpy()
    elab = expand_labels(as_tensor(labels, torch.int32).cpu(), blank_id).numpy()
    lens = as_tensor(logit_lengths, torch.int64).cpu().numpy()
    lab_lens = as_tensor(label_lengths, torch.int64).cpu().numpy()
    out = []
    for i in range(delta.shape[0]):
        t_last = int(lens[i]) - 1
        if t_last < 0:
            out.append(np.zeros(0, np.int32))
            continue
        last_blank = 2 * int(lab_lens[i])
        last_label = max(last_blank - 1, 0)
        s = (
            last_blank
            if delta[i, t_last, last_blank] >= delta[i, t_last, last_label]
            else last_label
        )
        states = np.zeros(t_last + 1, np.int32)
        states[t_last] = s
        for t in range(t_last, 0, -1):
            s = s - int(psi[i, t, s])
            states[t - 1] = s
        out.append(elab[i, states].astype(np.int32))
    return out


def align_to_segments(
    alignment: np.ndarray, blank_id: int = 0
) -> List[Tuple[int, int, int]]:
    """Collapse a frame alignment into (label, start_frame, end_frame+1)
    segments, dropping blanks (for CTM-style output)."""
    segs: List[Tuple[int, int, int]] = []
    prev = None
    start = 0
    for t, l in enumerate(alignment):
        l = int(l)
        if l != prev:
            if prev is not None and prev != blank_id:
                segs.append((prev, start, t))
            prev, start = l, t
    if prev is not None and prev != blank_id:
        segs.append((prev, start, len(alignment)))
    return segs
