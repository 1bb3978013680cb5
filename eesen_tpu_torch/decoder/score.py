"""WER/CER scoring (reference: src/decoderbin/compute-wer.cc).

Accumulates word/token error rates over (reference, hypothesis) pairs with
per-type counts and sentence error rate, matching compute-wer's report."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

from eesen_tpu_torch.utils.edit_distance import edit_distance_stats


@dataclasses.dataclass
class WerStats:
    errors: int = 0
    ref_tokens: int = 0
    insertions: int = 0
    deletions: int = 0
    substitutions: int = 0
    num_sentences: int = 0
    error_sentences: int = 0
    absent_sentences: int = 0

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(self.ref_tokens, 1)

    @property
    def ser(self) -> float:
        return 100.0 * self.error_sentences / max(self.num_sentences, 1)

    def add(self, ref: Sequence, hyp: Sequence) -> None:
        total, ins, dele, sub = edit_distance_stats(ref, hyp)
        self.errors += total
        self.insertions += ins
        self.deletions += dele
        self.substitutions += sub
        self.ref_tokens += len(ref)
        self.num_sentences += 1
        if total > 0:
            self.error_sentences += 1

    def report(self) -> str:
        """compute-wer-style summary line."""
        return (
            f"%WER {self.wer:.2f} [ {self.errors} / {self.ref_tokens}, "
            f"{self.insertions} ins, {self.deletions} del, "
            f"{self.substitutions} sub ] "
            f"%SER {self.ser:.2f} [ {self.error_sentences} / "
            f"{self.num_sentences} ]"
        )


def compute_wer(
    refs: Dict[str, Sequence],
    hyps: Dict[str, Sequence],
    mode: str = "present",
) -> WerStats:
    """mode: 'present' scores only utterances with a hypothesis; 'all'
    counts missing hypotheses as all-deletions (compute-wer --mode)."""
    stats = WerStats()
    for key, ref in refs.items():
        if key not in hyps:
            stats.absent_sentences += 1
            if mode == "all":
                stats.add(ref, [])
            continue
        stats.add(ref, hyps[key])
    return stats
