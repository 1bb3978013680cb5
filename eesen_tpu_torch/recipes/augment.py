"""Multi-warp VTLN + multi-rate feature augmentation (LibriSpeech flow).

The reference's best LibriSpeech number (8.15% test_clean,
asr_egs/librispeech/RESULTS:11) trains on NINE augmented feature views of
the corpus: {frame-shift 8, 10, 11 ms} x {VTLN warp 0.8, 1.0, 1.2}
(run_nml_seq_fw_seq_tw.sh:92-99 make_fbank_mult over fbconf-{8,10,11}
with --vtln-warp; varying the frame shift emulates speed perturbation at
the feature level), with CMVN stats computed once on the canonical
10_1.0 view and applied to every view
(compute_cmvn_stats_mult.sh --tag 10_1.0), and an epoch driver that
rotates one tag per epoch in a fixed order
(steps/train_ctc_parallel_mult.sh:205 train_tag_idx=(iter-1)%n).

This module provides the tag set, the rotation, and the per-tag feature
computation; RecipeRun.train(tagged_feats=..., tag_order=...) consumes
them (the Trainer passes the newbob epoch into the batch source).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class AugmentTag:
    frame_shift_ms: float = 10.0
    vtln_warp: float = 1.0

    @property
    def name(self) -> str:
        return f"{self.frame_shift_ms:g}_{self.vtln_warp:g}"


def librispeech_tags() -> List[AugmentTag]:
    """The 9 distinct views of the reference recipe."""
    return [
        AugmentTag(shift, warp)
        for shift in (8.0, 10.0, 11.0)
        for warp in (0.8, 1.0, 1.2)
    ]


# the exact rotation list of run_nml_seq_fw_seq_tw.sh:136 --tags
# "10_1.0 8_1.0 11_1.0 8_0.8 10_1.2 10_1.0 11_0.8 8_1.2 10_0.8 11_1.2"
# (the canonical 10_1.0 view appears twice per cycle)
LIBRISPEECH_ROTATION = [
    "10_1", "8_1", "11_1", "8_0.8", "10_1.2", "10_1", "11_0.8",
    "8_1.2", "10_0.8", "11_1.2",
]


def rotation_tag(tag_order: Sequence[str], epoch: int) -> str:
    """Reference epoch->tag mapping (train_ctc_parallel_mult.sh:205):
    1-based epoch, fixed cyclic order."""
    return tag_order[(epoch - 1) % len(tag_order)]


def base_tag(tags: Sequence[AugmentTag]) -> AugmentTag:
    """The canonical (10 ms, warp 1.0) view: CMVN source and CV/decode
    features."""
    for t in tags:
        if t.frame_shift_ms == 10.0 and t.vtln_warp == 1.0:
            return t
    return tags[0]
