"""Batch assembly: length-sorted bucketing with a frame-area cap.

Mirrors the reference's batching semantics
(reference: src/netbin/train-ctc-parallel.cc:146-195 — read up to
`num_sequence` utterances, close the batch early when
`max_len * (n+1) > frame_limit`; over-long single utterances skipped
:161-164; steps/train_ctc_parallel.sh:84-93 sorts utterances by length
first so batches have minimal padding).

On TPU we additionally pad (T, B) up to bucket shapes so XLA compiles a
small, fixed set of programs instead of one per batch shape.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    num_sequence: int = 16          # utterances per batch (reference default 5)
    frame_limit: int = 100000       # batch area cap (reference frame_num_limit)
    sort_by_len: bool = True
    min_len: int = 1
    # pad T up to a multiple of this so XLA sees few distinct shapes
    time_quant: int = 128
    # pad B up to num_sequence always (static batch) when True
    fixed_batch: bool = True
    # pad labels to the (quantized) feature length — required for the CE
    # objective, whose labels are one frame-aligned target per frame
    frame_labels: bool = False


@dataclasses.dataclass
class Utterance:
    key: str
    feats: np.ndarray          # [T, D] float32
    labels: np.ndarray         # [L] int32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_batches(
    utts: Sequence[Utterance], cfg: BatchConfig
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield padded batches:
    feats [B, T, D], feat_lengths [B], labels [B, L], label_lengths [B],
    keys (list).  Padded rows (beyond the real utterances) have length 0
    and contribute nothing to loss/gradient."""
    order = (
        sorted(range(len(utts)), key=lambda i: len(utts[i].feats))
        if cfg.sort_by_len
        else list(range(len(utts)))
    )
    cur: List[Utterance] = []
    max_len = 0
    for i in order:
        u = utts[i]
        t = len(u.feats)
        if t < cfg.min_len:
            continue
        if t > cfg.frame_limit:
            continue  # reference: skipped with a warning
        new_max = max(max_len, t)
        if cur and (
            len(cur) >= cfg.num_sequence
            or new_max * (len(cur) + 1) > cfg.frame_limit
        ):
            yield _pad_batch(cur, cfg)
            cur, max_len = [], 0
            new_max = t
        cur.append(u)
        max_len = new_max
    if cur:
        yield _pad_batch(cur, cfg)


def _pad_batch(utts: List[Utterance], cfg: BatchConfig) -> Dict[str, np.ndarray]:
    bsz = cfg.num_sequence if cfg.fixed_batch else len(utts)
    t_max = _round_up(max(len(u.feats) for u in utts), cfg.time_quant)
    l_max = t_max if cfg.frame_labels else max(
        max(len(u.labels) for u in utts), 1
    )
    dim = utts[0].feats.shape[1]
    feats = np.zeros((bsz, t_max, dim), dtype=np.float32)
    feat_lengths = np.zeros((bsz,), dtype=np.int32)
    labels = np.zeros((bsz, l_max), dtype=np.int32)
    label_lengths = np.zeros((bsz,), dtype=np.int32)
    keys = []
    for i, u in enumerate(utts):
        feats[i, : len(u.feats)] = u.feats
        feat_lengths[i] = len(u.feats)
        labels[i, : len(u.labels)] = u.labels
        label_lengths[i] = len(u.labels)
        keys.append(u.key)
    return {
        "feats": feats,
        "feat_lengths": feat_lengths,
        "labels": labels,
        "label_lengths": label_lengths,
        "keys": keys,
    }
