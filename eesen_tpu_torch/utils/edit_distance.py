"""Levenshtein edit distance and alignment.

Used for token-error-rate monitoring during training and WER scoring
(reference: src/util/edit-distance{,-inl}.h, src/decoderbin/compute-wer.cc:69).
"""

from __future__ import annotations

from typing import Hashable, List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence[Hashable], hyp: Sequence[Hashable]) -> int:
    """Plain Levenshtein distance (ins/del/sub all cost 1)."""
    return edit_distance_stats(ref, hyp)[0]


def edit_distance_stats(
    ref: Sequence[Hashable], hyp: Sequence[Hashable]
) -> Tuple[int, int, int, int]:
    """Return (total, insertions, deletions, substitutions).

    EXACT mirror of the reference recursion and its tie-breaking
    (src/util/edit-distance-inl.h:77-123): substitution only when
    strictly cheaper than both alternatives, deletion only when strictly
    cheaper than insertion — so on ties insertion wins, then deletion,
    then substitution.  The breakdown compute-wer prints depends on this
    order (cross-validated against the compiled reference binary in
    tests/test_reference_parity.py).
    """
    # e[ref_index] = (total, ins, del, sub) for hyp[:h] vs ref[:ref_index]
    e = [(i, 0, i, 0) for i in range(len(ref) + 1)]
    for h in range(1, len(hyp) + 1):
        cur = [(e[0][0] + 1, e[0][1] + 1, e[0][2], e[0][3])]
        for r in range(1, len(ref) + 1):
            ins_err = e[r][0] + 1
            del_err = cur[r - 1][0] + 1
            sub_err = e[r - 1][0] + (hyp[h - 1] != ref[r - 1])
            if sub_err < ins_err and sub_err < del_err:
                t, i_, d_, s_ = e[r - 1]
                cur.append((sub_err, i_, d_,
                            s_ + (hyp[h - 1] != ref[r - 1])))
            elif del_err < ins_err:
                t, i_, d_, s_ = cur[r - 1]
                cur.append((del_err, i_, d_ + 1, s_))
            else:
                t, i_, d_, s_ = e[r]
                cur.append((ins_err, i_ + 1, d_, s_))
        e = cur
    return e[len(ref)]


def align_pair(
    ref: Sequence[Hashable], hyp: Sequence[Hashable], eps: Hashable = None
) -> List[Tuple[Hashable, Hashable]]:
    """Return the aligned (ref, hyp) pairs; `eps` marks ins/del gaps.

    Mirrors LevenshteinAlignment (reference: src/util/edit-distance-inl.h:117+),
    used for per-utterance alignment output and sclite-style scoring.
    """
    n, m = len(ref), len(hyp)
    cost = np.zeros((n + 1, m + 1), dtype=np.int32)
    cost[:, 0] = np.arange(n + 1)
    cost[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = cost[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dele = cost[i - 1, j] + 1
            ins = cost[i, j - 1] + 1
            cost[i, j] = min(sub, dele, ins)
    # traceback
    out: List[Tuple[Hashable, Hashable]] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and cost[i, j] == cost[i - 1, j - 1] + (
            ref[i - 1] != hyp[j - 1]
        ):
            out.append((ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and cost[i, j] == cost[i - 1, j] + 1:
            out.append((ref[i - 1], eps))
            i -= 1
        else:
            out.append((eps, hyp[j - 1]))
            j -= 1
    out.reverse()
    return out
