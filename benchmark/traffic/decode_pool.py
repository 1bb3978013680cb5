"""Decode traffic: converged CTC log-posteriors of sentences from the
language model's own text process, cut into length-sorted chunks.

Sizes come from the traffic file alone (`sizes_seed`): every seed gives
the same utterance lengths, and so the same chunks.  The seed draws the
contents and the order in which the chunks are served.

- Lengths are log-normal with the eval sets' mean (`mean_s`), clipped
  to [min_s, max_s], in frames of the configuration's `frame_s`.
- Each utterance is filled with whole words of sentences of the text
  process (graph/text.py, the configuration's `text_seed`): every phone
  of a word's pron gives `spike_frames` frames whose own column is
  raised by `spike_logit`, then `blank_frames` frames whose blank column
  is raised by `blank_logit`, over normal noise of `noise` (the form of
  chip_smoke.synth_posteriors).  The first word that does not fit ends
  the utterance, and blank frames fill it to its length.
- Utterances are sorted by length, longest first, into chunks of
  `batch` rows, each padded with zeros to a multiple of `time_bucket`
  frames (recipes/run._pad_chunk's layout), served in the order of
  traffic/order.py (`strata`).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from benchmark.graph.text import build_text_process, sample_sentences
from benchmark.traffic.order import stratified


class Chunk(NamedTuple):
    lp: np.ndarray        # [B, T, V] float32, zero past each length
    lengths: np.ndarray   # [B] int32
    utts: np.ndarray      # [B] utterance index (-1 for a padded row)


def sizes(spec: Dict, frame_s: float) -> np.ndarray:
    rng = np.random.default_rng(spec["sizes_seed"])
    sig = spec["sigma"]
    mu = math.log(spec["mean_s"]) - sig * sig / 2.0
    dur = np.clip(rng.lognormal(mu, sig, spec["utterances"]),
                  spec["min_s"], spec["max_s"])
    return np.maximum(1, np.round(dur / frame_s)).astype(np.int64)


def _columns(n_frames: int, prons, succ, slot_p, vocab, rng, spec):
    """The column raised at each frame (0 = blank) of one utterance."""
    s_lo, s_hi = spec["spike_frames"]
    b_lo, b_hi = spec["blank_frames"]
    cols: List[np.ndarray] = []
    used = 0
    while True:
        sent = sample_sentences(1, succ, slot_p, vocab, rng)[0]
        for w in sent:
            toks = prons[int(w)]
            toks = toks[toks > 0]
            spikes = rng.integers(s_lo, s_hi + 1, size=len(toks))
            blanks = rng.integers(b_lo, b_hi + 1, size=len(toks))
            n = int(spikes.sum() + blanks.sum())
            if used + n > n_frames:
                cols.append(np.zeros(n_frames - used, np.int64))
                return np.concatenate(cols)
            word = np.zeros(n, np.int64)
            pos = 0
            for tok, s, b in zip(toks, spikes, blanks):
                word[pos:pos + s] = tok - 1
                pos += s + b
            cols.append(word)
            used += n


def make(spec: Dict, cfg: Dict, prons: np.ndarray, seed: int, device
         ) -> List[Chunk]:
    """The pool's chunks, longest first."""
    g = cfg["decode_graph"]
    succ, slot_p = build_text_process(
        g["vocab"], np.random.default_rng(g["text_seed"]))
    lengths = sizes(spec, cfg["frame_s"])
    rng = np.random.default_rng(seed)
    cols = [_columns(int(n), prons, succ, slot_p, g["vocab"], rng, spec)
            for n in lengths]
    v = cfg["num_targets"]
    flat = torch.from_numpy(np.concatenate(cols)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((len(flat), v), generator=gen, device=device) \
        * spec["noise"]
    bump = torch.where(flat == 0, spec["blank_logit"], spec["spike_logit"])
    x[torch.arange(len(flat), device=device), flat] += bump.float()
    lp = torch.log_softmax(x, dim=-1).cpu().numpy()
    off = np.concatenate([[0], np.cumsum(lengths)])
    order = sorted(range(len(lengths)), key=lambda i: (-lengths[i], i))
    chunks = []
    bsz, q = spec["batch"], spec["time_bucket"]
    for c in range(0, len(order), bsz):
        ids = order[c:c + bsz]
        t_max = -(-int(lengths[ids[0]]) // q) * q
        arr = np.zeros((bsz, t_max, v), np.float32)
        lens = np.zeros(bsz, np.int32)
        utts = np.full(bsz, -1, np.int64)
        for j, i in enumerate(ids):
            arr[j, :lengths[i]] = lp[off[i]:off[i + 1]]
            lens[j] = lengths[i]
            utts[j] = i
        chunks.append(Chunk(arr, lens, utts))
    return chunks


def serve_order(n_chunks: int, seed: int, strata: int):
    """An endless sequence of chunk indices (traffic/order.py): every pass
    all chunks, in a new seeded order of mixed lengths."""
    return stratified(n_chunks, seed, 2, strata)
