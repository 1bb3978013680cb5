"""Frame-level cross-entropy loss (counterpart of eesen_tpu/ops/ce.py).

The reference's CE objective (src/net/ce-loss.{h,cc}: per-frame softmax
cross-entropy against frame labels with padded frames masked, plus the
frame-accuracy monitor; used by the train-ce{,-parallel} binaries).
Plain torch; autograd gives softmax - one-hot on valid frames."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def ce_loss(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    frame_labels: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits [B, T, V], frame_labels [B, T] -> (mean loss per frame,
    metrics {obj_sum, frames, correct})."""
    b, t_max, _ = logits.shape
    dev = logits.device
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    mask = (torch.arange(t_max, device=dev)[None, :]
            < logit_lengths.to(dev)[:, None])
    labels = frame_labels.to(dev, torch.int64)
    picked = lp.gather(2, labels[..., None])[..., 0]
    nll = -torch.where(mask, picked, 0.0)
    frames = torch.clamp(logit_lengths.to(dev).sum(), min=1)
    obj_sum = nll.sum()
    pred = lp.argmax(dim=-1)
    correct = ((pred == labels) & mask).sum()
    return obj_sum / frames.to(nll.dtype), {
        "obj_sum": obj_sum,
        "frames": frames,
        "correct": correct,
    }
