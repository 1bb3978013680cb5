"""Greedy (best-path) CTC decoding (counterpart of
eesen_tpu/decoder/greedy.py).

Frame-level argmax, collapse repeats, drop blanks: what the reference
uses for token-error-rate monitoring (src/net/ctc-loss.cc:196-299) and
quick checks.  The argmax runs on the logits' device over the whole
batch; the collapse is a host loop.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from eesen_tpu_torch.models.model import as_tensor
from eesen_tpu_torch.training.metrics import collapse_ctc_path


def greedy_decode_logits(logits, lengths, blank: int = 0) -> List[List[int]]:
    """logits [B, T, V] (any device) -> list of collapsed label sequences."""
    argmax = as_tensor(logits, torch.float32).argmax(dim=-1).cpu().numpy()
    lens = np.asarray(
        lengths.cpu() if torch.is_tensor(lengths) else lengths
    )
    return [
        collapse_ctc_path(argmax[i, : int(lens[i])], blank)
        for i in range(argmax.shape[0])
    ]


def greedy_decode(log_probs: np.ndarray, blank: int = 0) -> List[int]:
    """Single-utterance [T, V] log-probs -> collapsed labels."""
    return collapse_ctc_path(np.argmax(log_probs, axis=-1), blank)
