"""Blank-frame skipping (phone-synchronous) decode compaction, in torch
ops on the log-posteriors' device (counterpart of
eesen_tpu/decoder/frame_skip.py).

CTC acoustic models are blank-dominated: on converged models most frames
carry a blank posterior near 1.0.  Phone-synchronous decoding (Chen,
Zhang, Yan, Qian, Interspeech 2016) runs the search only on informative
frames.  Every blank RUN is merged into its LAST frame, whose column c
becomes

    sum over the run of ll[blank]  +  max over the run of (ll[c] - ll[blank])

the exact cost of consuming the run with blanks everywhere except one
optimally placed transition of label c (for c = blank the max term is 0
and the run cost is the exact blank sum).  The compacted search equals
the full search restricted to paths that change state at most once
inside each blank run; threshold -> 1 recovers the exact search.  The
JAX package's module docstring gives the measurements behind these
semantics.

The compaction is a stable partition ([B, T, V] with run-merged columns,
merged frames moved to the back), then a host read of the longest kept
count and a slice of the kept prefix rounded up to a bucket.  It is no
Pallas kernel in the JAX package, so it is torch ops here, on the CPU and
on the card alike.  One step differs in form: the JAX package's
segmented running max (an associative scan) is an exact segment max
here, `scatter_reduce(..., "amax")` over each frame's kept slot, gathered
back by the partition's order; max is exact in any order, so the kept
slots hold the same values.  Slots past a row's kept count hold garbage
in both packages (masked by `lengths` in the search).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from eesen_tpu_torch.models.model import as_tensor
from eesen_tpu_torch.utils.profile import profiler


class CompactFrames(NamedTuple):
    loglikes: torch.Tensor   # [B, T', V] kept frames (run-summed), packed front
    lengths: torch.Tensor    # [B] int32 kept-frame count
    time_map: torch.Tensor   # [B, T'] int64 original frame index of slot t
    #                          (a blank run maps to its last frame)


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    """x[:, 1:] with `fill` appended: each frame sees its successor."""
    pad = torch.full_like(x[:, :1], fill)
    return torch.cat([x[:, 1:], pad], dim=1)


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """`fill` then x[:, :-1]: each frame sees its predecessor."""
    pad = torch.full_like(x[:, :1], fill)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _partition(
    loglikes: torch.Tensor, lengths: torch.Tensor, log_thresh: float,
    min_run: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (packed [B, T, V], count [B] int32, order [B, T] int64)."""
    b, t, _ = loglikes.shape
    dev = loglikes.device
    ts = torch.arange(t, device=dev)[None, :]
    active = ts < lengths[:, None]
    blank_lp = loglikes[:, :, 0]
    bd = active & (blank_lp >= log_thresh)          # blank-dominated
    if min_run > 1:
        # only runs of >= min_run frames merge (the JAX package's
        # optional conservatism; its docstring says why it is off)
        start_t = torch.where(bd & ~_shift_right(bd, False), ts, -1)
        run_start = torch.cummax(start_t, dim=1).values
        end_t = torch.where(bd & ~_shift_left(bd, False), ts, t + 1)
        run_end = torch.flip(
            torch.cummin(torch.flip(end_t, dims=(1,)), dim=1).values,
            dims=(1,),
        )
        bd = bd & (run_end - run_start + 1 >= min_run)
    run_tail = bd & ~_shift_left(bd, False)         # last frame of each run
    keep = (active & ~bd) | run_tail
    count = keep.sum(dim=1, dtype=torch.int32)
    # stable partition: kept frames first, original order preserved
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    # kept slot j covers the contiguous segment (order[j-1], order[j]];
    #   packed[j, c] = sum_{t in seg} blank[t] + max_{t in seg} rel[t, c]
    # with rel = ll - blank
    blank_act = torch.where(active, blank_lp, torch.zeros_like(blank_lp))
    cs = torch.cat(
        [torch.zeros_like(blank_act[:, :1]), torch.cumsum(blank_act, dim=1)],
        dim=1,
    )
    hi = cs.gather(1, order + 1)
    lo = cs.gather(1, _shift_right(order, -1) + 1)
    seg_blank = hi - lo                              # [B, T]
    rel = torch.where(
        active[:, :, None], loglikes - blank_lp[:, :, None],
        torch.full_like(loglikes, -math.inf),
    )
    # frame t belongs to the kept slot numbered by its exclusive count of
    # kept frames; the segment max is a scatter-max over that slot
    seg_id = torch.cumsum(keep, dim=1) - keep.long()        # [B, T]
    v = loglikes.shape[2]
    idx = seg_id[:, :, None].expand(-1, -1, v)
    segmax = torch.full_like(rel, -math.inf).scatter_reduce(
        1, idx, rel, reduce="amax", include_self=True,
    )
    slot_of = seg_id.gather(1, order)[:, :, None].expand(-1, -1, v)
    seg_rel = segmax.gather(1, slot_of)
    packed = seg_blank[:, :, None] + seg_rel
    return packed, count, order


def compact_blank_frames(
    loglikes,
    lengths,
    threshold: float,
    bucket: int = 64,
    min_run: int = 1,
) -> CompactFrames:
    """Merge each blank-dominated run into one run-summed frame.

    loglikes [B, T, V] log-posteriors (column 0 = blank), lengths [B],
    on any device (host arrays run on the CPU).  Returns frames packed to
    the front and sliced to the smallest multiple of `bucket` >= the
    longest kept count, capped at T.  Costs of run-spanning paths equal
    the full decode's (module docstring)."""
    if not (0.0 < threshold < 1.0):
        raise ValueError(f"threshold must be in (0, 1), got {threshold}")
    with profiler.track("decode.compact"):
        ll = as_tensor(loglikes, torch.float32)
        lens = as_tensor(lengths, torch.int64).to(ll.device)
        t = ll.shape[1]
        packed, count, order = _partition(ll, lens, math.log(threshold),
                                          min_run)
        t_keep = int(count.max()) if count.shape[0] else 0  # one host read
        t_new = min(max(bucket, -(-t_keep // bucket) * bucket), t)
        return CompactFrames(packed[:, :t_new], count, order[:, :t_new])
