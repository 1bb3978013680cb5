"""The recipes' feature pipeline as one configured, jittable transform.

The reference materializes this as a shell pipe per data pass
(reference: steps/train_ctc_parallel.sh:95-111 and
steps/decode_ctc_lat.sh:92-95:
  apply-cmvn --norm-vars=true [--utt2spk] | [splice-feats] |
  [subsample-feats --n=3 --offset=k] | add-deltas
producing e.g. 40-dim fbank -> 120-dim (+Δ,ΔΔ) inputs, or the 30ms
frame-rate variant with splice ±1 and subsample x3
(steps/train_ctc_parallel_x3.sh:115-169)).

Here it is a configuration object applied on host (numpy path, for
per-utterance shapes) or in-jit (fixed shapes).  Per-speaker CMVN stats
come from a {speaker: stats} dict plus utt2spk, exactly like cmvn.scp +
--utt2spk=ark:utt2spk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from eesen_tpu_torch.frontend.features import (
    apply_cmvn, cmvn_stats, compute_deltas, splice_frames, subsample_frames,
)


@dataclasses.dataclass(frozen=True)
class FeaturePipelineConfig:
    norm_vars: bool = True
    splice_left: int = 0
    splice_right: int = 0
    subsample_n: int = 1
    subsample_offset: int = 0
    delta_order: int = 2           # 0 disables add-deltas
    delta_window: int = 2


class FeaturePipeline:
    """Applies CMVN -> splice -> subsample -> deltas per utterance."""

    def __init__(
        self,
        cfg: FeaturePipelineConfig,
        cmvn_by_spk: Optional[Dict[str, np.ndarray]] = None,
        utt2spk: Optional[Dict[str, str]] = None,
    ):
        self.cfg = cfg
        self.cmvn_by_spk = cmvn_by_spk or {}
        self.utt2spk = utt2spk or {}

    def output_dim(self, input_dim: int) -> int:
        d = input_dim
        d *= 1 + self.cfg.splice_left + self.cfg.splice_right
        d *= 1 + self.cfg.delta_order
        return d

    def __call__(self, utt: str, feats: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        out = np.asarray(feats)
        stats = self._stats_for(utt)
        if stats is not None:
            out = np.asarray(apply_cmvn(out, stats, cfg.norm_vars))
        if cfg.splice_left or cfg.splice_right:
            out = np.asarray(
                splice_frames(out, cfg.splice_left, cfg.splice_right)
            )
        if cfg.subsample_n > 1:
            out = np.asarray(
                subsample_frames(out, cfg.subsample_n, cfg.subsample_offset)
            )
        if cfg.delta_order > 0:
            out = np.asarray(
                compute_deltas(out, cfg.delta_order, cfg.delta_window)
            )
        return out

    def subsampled_copies(self, utt: str, feats: np.ndarray) -> List[np.ndarray]:
        """The x3 frame-rate trick: all `subsample_n` offset copies of one
        utterance as separate training examples
        (steps/train_ctc_parallel_x3.sh:115-169)."""
        cfg = self.cfg
        return [
            FeaturePipeline(
                dataclasses.replace(cfg, subsample_offset=k),
                self.cmvn_by_spk, self.utt2spk,
            )(utt, feats)
            for k in range(cfg.subsample_n)
        ]

    def _stats_for(self, utt: str) -> Optional[np.ndarray]:
        if not self.cmvn_by_spk:
            return None
        spk = self.utt2spk.get(utt, utt)
        return self.cmvn_by_spk.get(spk)


def speaker_cmvn_stats(
    feats_by_utt: Dict[str, np.ndarray], utt2spk: Dict[str, str]
) -> Dict[str, np.ndarray]:
    """Accumulate per-speaker CMVN stats
    (reference: steps/compute_cmvn_stats.sh -> compute-cmvn-stats
    --spk2utt)."""
    by_spk: Dict[str, List[np.ndarray]] = {}
    for utt, f in feats_by_utt.items():
        by_spk.setdefault(utt2spk.get(utt, utt), []).append(np.asarray(f))
    return {
        spk: np.asarray(cmvn_stats(np.concatenate(fs, axis=0)))
        for spk, fs in by_spk.items()
    }
