"""Beam-search recombination: the CUDA kernel `csrc/dedup_prune.cu` and
its plain PyTorch version.

Replaces the TPU kernel `_dedup_prune_kernel` (eesen_tpu/ops/
beam_pallas.py:110) and its wrapper `dedup_prune`: the beam threshold
against the row's best proposal, Viterbi recombination (the best proposal
per destination state; the reference's hash-map token recombination in
src/decoder/faster-decoder.cc ProcessEmitting), and top-K, in one launch.

The order of ties is fixed: sorts are lexicographic with the proposal's
lane as the last key, so the kernel and `dedup_prune_ref` agree exactly.
The kernel sorts no whole row: one thread-block cluster of CLUSTER CTAs
per row keeps the best (score, lane) per destination in a hash table in
distributed shared memory (TABLE_LOAD_INV * Mp slots), finds the K-th
best winner by radix select, and sorts only the survivors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from eesen_tpu_torch.ops import build

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0
# launches recorded into a CUDA graph under stream capture: they run at
# each replay, which adds them to `launches` (decoder/beam._FrameGraph)
captured = 0

# (device index, Mp, K) readied by the library's dedup_prune_ready: once
# per device and shape, so a launch queries nothing and a CUDA graph
# capture takes it
_ready = set()

PAD_DST = 0x3FFFFFFF
MIN_LANES = 128
# widest padded proposal row the kernel takes (at most four lanes a thread
# of the cluster's 8 x 512)
MAX_LANES = 16384
CLUSTER = 8           # CTAs per row, each owning Mp / CLUSTER lanes
TABLE_LOAD_INV = 2    # hash-table slots per padded lane (load <= 0.5)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def padded_width(m: int) -> int:
    """Lanes the kernel sorts for m proposals."""
    return max(next_pow2(m), MIN_LANES)


def smem_bytes(mp: int, k: int) -> int:
    """Dynamic shared memory of one CTA of the kernel (csrc/dedup_prune.cu
    dedup_prune_smem_bytes): its share of the table, a 64-bit key and a
    32-bit tag per slot plus the slot kept for the empty tag, or, where
    larger, the survivors' sort buffer of next_pow2(k) keys that CTA 0
    puts in the same place; rounded up to 16 bytes."""
    slots = TABLE_LOAD_INV * mp // CLUSTER + 1
    return -(-max(12 * slots, 8 * next_pow2(k)) // 16) * 16


def lexsort_rows(keys) -> torch.Tensor:
    """Per-row permutation sorting ascending by keys[0], then keys[1], ...,
    then by position (stable sorts from the last key to the first)."""
    order = None
    for key in reversed(keys):
        k = key if order is None else key.gather(1, order)
        o = torch.sort(k, dim=1, stable=True).indices
        order = o if order is None else order.gather(1, o)
    return order


def dedup_prune_ref(
    dst: torch.Tensor, score: torch.Tensor, k: int, beam: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, tie order included.  dst [B, M] int32,
    score [B, M] float32 (inf = dead) -> (states [B, K] int32, -1 where
    dead; scores [B, K] float32; kept [B, K] int32 lanes, clamped to
    M-1)."""
    b, m = dst.shape
    mp = padded_width(m)
    if k > mp:
        raise ValueError(f"k={k} exceeds the padded width {mp}")
    pad = mp - m
    dev = dst.device
    if pad:
        dst = torch.cat(
            [dst, torch.full((b, pad), PAD_DST, dtype=torch.int32, device=dev)],
            dim=1,
        )
        score = torch.cat(
            [score, torch.full((b, pad), float("inf"), device=dev)], dim=1
        )
    score = score + 0.0        # -0.0 -> +0.0: the kernel compares them equal
    best = score.min(dim=1, keepdim=True).values
    inf = torch.tensor(float("inf"), device=dev)
    score = torch.where(score <= best + beam, score, inf)
    # pass 1: (dst, score, lane); the first lane of each dst run wins
    order = lexsort_rows([dst, score])
    d2 = dst.gather(1, order)
    s2 = score.gather(1, order)
    first = torch.ones_like(d2, dtype=torch.bool)
    first[:, 1:] = d2[:, 1:] != d2[:, :-1]
    s2 = torch.where(first, s2, inf)
    # pass 2: (score, lane) over the winners' scores put back by lane
    s_lane = torch.empty_like(s2).scatter_(1, order, s2)
    kept = torch.sort(s_lane, dim=1, stable=True).indices[:, :k]
    scores = s_lane.gather(1, kept)
    states = torch.where(
        scores < inf, dst.gather(1, kept), torch.full_like(kept, -1)
    ).to(torch.int32)
    kept = torch.clamp(kept, max=m - 1).to(torch.int32)
    return states, scores, kept


def dedup_prune(
    dst: torch.Tensor, score: torch.Tensor, k: int, beam: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused beam + recombination + top-K.  dst [B, M] int32 proposal
    destinations, score [B, M] float32 (inf = dead).  Returns (states
    [B, K] int32 with -1 for dead slots, scores [B, K] float32, kept
    [B, K] int32 indices into the proposal axis).  CUDA tensors launch
    the kernel (padded width up to MAX_LANES); CPU tensors run
    `dedup_prune_ref`."""
    global launches, captured
    if dst.device.type == "cpu":
        return dedup_prune_ref(dst, score, k, beam)
    if dst.device.type != "cuda":
        raise ValueError(f"dedup_prune: unsupported device {dst.device}")
    b, m = dst.shape
    mp = padded_width(m)
    if mp > MAX_LANES:
        raise ValueError(
            f"dedup_prune: proposal width {m} exceeds the kernel cap "
            f"{MAX_LANES}"
        )
    if k > mp:
        raise ValueError(f"dedup_prune: k={k} exceeds the padded width {mp}")
    if dst.dtype != torch.int32 or score.dtype != torch.float32:
        raise TypeError("dedup_prune: dst must be int32 and score float32")
    if tuple(score.shape) != (b, m) or score.device != dst.device:
        raise ValueError("dedup_prune: dst and score must match")
    dst = dst.contiguous()
    score = score.contiguous()
    states = torch.empty((b, k), dtype=torch.int32, device=dst.device)
    scores = torch.empty((b, k), dtype=torch.float32, device=dst.device)
    kept = torch.empty((b, k), dtype=torch.int32, device=dst.device)
    if b > 0 and k > 0:
        _ready_for(dst.device, mp, k)
        with torch.cuda.device(dst.device):
            err = build.load().dedup_prune(
                dst.data_ptr(), score.data_ptr(), states.data_ptr(),
                scores.data_ptr(), kept.data_ptr(), b, m, mp, k, float(beam),
                torch.cuda.current_stream().cuda_stream,
            )
            capturing = torch.cuda.is_current_stream_capturing()
        build.check(err, "dedup_prune")
        if capturing:
            captured += 1
        else:
            launches += 1
    return states, scores, kept


def _ready_for(device: torch.device, mp: int, k: int) -> None:
    """Ready the kernel for (mp, k) on `device` once: its shared-memory
    allowance; raises where no cluster can be resident."""
    key = (device.index, mp, k)
    if key not in _ready:
        with torch.cuda.device(device):
            active = build.load().dedup_prune_ready(mp, k)
        if active < 0:
            build.check(-active, "dedup_prune")
        _ready.add(key)
