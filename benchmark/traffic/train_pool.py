"""Training traffic: a pool of utterances of a corpus's lengths.

Sizes come from the traffic file alone (`sizes_seed`), so every seed
gives the same lengths and label counts and so the same work; the seed
draws the contents: the order of the batches, features (normal, drawn on
the device in one call), and labels (uniform over the non-blank units).

- Durations are log-normal with the corpus's mean (`mean_s`; `sigma` is
  the log-space spread), clipped to [min_s, max_s], and cut into frames
  of the configuration's `frame_s`.
- Labels: `labels_per_s` of them a second, at most half the frames (so a
  CTC path always exists: a label may need a blank before it).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.traffic.order import stratified


def sizes(spec: Dict, frame_s: float) -> Tuple[np.ndarray, np.ndarray]:
    """(frames [N], labels [N]) of the pool, the same for every seed."""
    rng = np.random.default_rng(spec["sizes_seed"])
    n, sig = spec["utterances"], spec["sigma"]
    mu = math.log(spec["mean_s"]) - sig * sig / 2.0
    dur = np.clip(rng.lognormal(mu, sig, n), spec["min_s"], spec["max_s"])
    frames = np.maximum(1, np.round(dur / frame_s)).astype(np.int64)
    labels = np.clip(np.round(dur * spec["labels_per_s"]), 1,
                     np.maximum(frames // 2, 1)).astype(np.int64)
    return frames, labels


def make(spec: Dict, cfg: Dict, seed: int, device) -> List:
    """The pool as the port's `Utterance`s (host numpy features)."""
    from eesen_tpu_torch.training.batching import Utterance

    frames, nlab = sizes(spec, cfg["frame_s"])
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, cfg["num_targets"], size=int(nlab.sum()),
                          dtype=np.int32)
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = torch.randn((int(frames.sum()), cfg["input_dim"]),
                        generator=gen, device=device).cpu().numpy()
    f_off = np.concatenate([[0], np.cumsum(frames)])
    l_off = np.concatenate([[0], np.cumsum(nlab)])
    return [Utterance(f"u{i:05d}", feats[f_off[i]:f_off[i + 1]],
                      labels[l_off[i]:l_off[i + 1]])
            for i in range(len(frames))]


def batches(spec: Dict, utts: List) -> List[Dict[str, np.ndarray]]:
    """The pool cut by the port's batcher (`make_batches`)."""
    from eesen_tpu_torch.training.batching import BatchConfig, make_batches

    return list(make_batches(utts, BatchConfig(**spec["batch"])))


def pass_orders(n_batches: int, seed: int, strata: int):
    """An endless sequence of batch indices (traffic/order.py): every
    pass all batches, in a new seeded order of mixed lengths."""
    return stratified(n_batches, seed, 1, strata)
