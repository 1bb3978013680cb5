"""Training metrics: greedy token error rate, objective reporting.

Mirrors the reference's TOKEN_ACCURACY monitoring
(reference: src/net/ctc-loss.cc:196-299 ErrorRate/ErrorRateMSeq — greedy
best-path decode, collapse repeats, drop blanks, Levenshtein vs the
reference labels; :300 Report).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from eesen_tpu_torch.utils.edit_distance import edit_distance


def collapse_ctc_path(path: Sequence[int], blank: int = 0) -> List[int]:
    """Remove repeats then blanks (greedy CTC decode of an argmax path)."""
    out: List[int] = []
    prev = None
    for p in path:
        if p != prev and p != blank:
            out.append(int(p))
        prev = p
    return out


def token_error_counts(
    argmax_paths: np.ndarray,
    path_lengths: np.ndarray,
    labels: np.ndarray,
    label_lengths: np.ndarray,
    blank: int = 0,
) -> Tuple[int, int]:
    """(errors, ref_tokens) accumulated over the batch.

    argmax_paths: [B, T] frame-level argmax ids (computed on device);
    the collapse + edit distance run on host, as in the reference
    (GPU argmax + CPU edit distance, ctc-loss.cc:235+).
    """
    errs = 0
    refs = 0
    for i in range(len(path_lengths)):
        n = int(path_lengths[i])
        if n == 0:
            continue
        hyp = collapse_ctc_path(argmax_paths[i, :n], blank)
        ref = [int(x) for x in labels[i, : int(label_lengths[i])]]
        errs += edit_distance(ref, hyp)
        refs += len(ref)
    return errs, refs


class EpochReport:
    """Accumulates per-epoch objective / accuracy, reports like the
    reference's Ctc::Report (obj per frame, TOKEN_ACCURACY %)."""

    def __init__(self) -> None:
        self.total_obj = 0.0
        self.total_frames = 0
        self.total_errs = 0
        self.total_refs = 0
        self.num_seqs = 0

    def update(
        self, obj_sum: float, frames: int, errs: int, refs: int, seqs: int
    ) -> None:
        self.total_obj += obj_sum
        self.total_frames += frames
        self.total_errs += errs
        self.total_refs += refs
        self.num_seqs += seqs

    @property
    def obj_per_frame(self) -> float:
        return self.total_obj / max(self.total_frames, 1)

    @property
    def token_accuracy(self) -> float:
        """Percent, 100 * (1 - TER), as grepped by the reference's shell
        driver to drive the LR schedule."""
        if self.total_refs == 0:
            return 0.0
        return 100.0 * (1.0 - self.total_errs / self.total_refs)

    def report(self, prefix: str = "") -> str:
        return (
            f"{prefix}Obj(log[Pzx]) = {self.obj_per_frame:.6f} "
            f"TOKEN_ACCURACY >> {self.token_accuracy:.2f}% <<"
        )
