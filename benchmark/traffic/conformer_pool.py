"""Training traffic of a Conformer-CTC cell: a pool of utterances of a
corpus's lengths, as traffic/train_pool.py makes it, with two changes.

- Durations are log-normal with the corpus's mean (`mean_s`, the law's
  mean before the cut) and log-space spread `sigma`, TRUNCATED to
  [min_s, max_s]: a draw outside is drawn again, as NeMo's loader drops
  utterances longer than its `max_duration` (the lengths are not
  clipped onto the bounds).
- Labels: `labels_per_s` of them a second, at most half the frames left
  after the model's x4 subsampling (so a CTC path always exists).

Sizes come from the traffic file alone (`sizes_seed`); the seed draws
the contents (features normal on the device in one call, labels uniform
over the non-blank units) and the order of the batches.  The batches
are the port's `make_batches` with the file's `batch` (`fixed_batch`
false: no empty rows).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.traffic.train_pool import batches, pass_orders  # noqa: F401


def subsampled(frames):
    """Frames after the x4 subsampling: floor((n+1)/2), twice."""
    return ((frames + 1) // 2 + 1) // 2


def durations(spec: Dict) -> np.ndarray:
    """The pool's durations in seconds, the same for every seed."""
    rng = np.random.default_rng(spec["sizes_seed"])
    n, sig = spec["utterances"], spec["sigma"]
    mu = math.log(spec["mean_s"]) - sig * sig / 2.0
    out = np.empty(0)
    while len(out) < n:
        d = rng.lognormal(mu, sig, n)
        d = d[(d >= spec["min_s"]) & (d <= spec["max_s"])]
        out = np.concatenate([out, d])
    return out[:n]


def sizes(spec: Dict, frame_s: float) -> Tuple[np.ndarray, np.ndarray]:
    """(frames [N], labels [N]) of the pool."""
    dur = durations(spec)
    frames = np.maximum(1, np.round(dur / frame_s)).astype(np.int64)
    labels = np.clip(np.round(dur * spec["labels_per_s"]), 1,
                     np.maximum(subsampled(frames) // 2, 1)).astype(np.int64)
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
