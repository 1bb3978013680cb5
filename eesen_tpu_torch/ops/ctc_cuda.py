"""CTC alpha/beta recursions: the CUDA kernels `csrc/ctc_alpha_beta.cu` and
their plain PyTorch version.

Replaces the TPU kernels `_alpha_kernel` and `_beta_kernel` (eesen_tpu/ops/
ctc_pallas.py:62 and :88) behind the contract of their wrapper
`ctc_alpha_beta_pallas`: expanded-label log-probabilities lp_e [B, T, S],
the additive skip mask [B, S] (0 where the s-2 -> s transition is allowed,
LOG_ZERO elsewhere), the beta init row [B, S] and the frame counts [B] give
alpha and beta [B, T, S] float32.  Alpha is frozen past a row's length;
beta is the init row at t = len-1 and LOG_ZERO after it.

`ctc_alpha_beta` is the wrapper: on a CUDA tensor it launches the two
kernels (or raises), on a CPU tensor it runs `ctc_alpha_beta_ref`.  The
kernels take any number of states S whose two shared rows fit in a block
(a thread owns ceil(S/1024) states, rounded up to a power of two), as the
TPU wrapper takes any S.  Each thread's log-probabilities come through a
ring of `depth` steps in shared memory filled by cp.async; `ctc_plan` is
the kernels' launch arithmetic (the library's `ctc_depth` /
`ctc_smem_bytes`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from eesen_tpu_torch.ops import build
from eesen_tpu_torch.utils.math import (
    LOG_ZERO, LOG_ZERO_THRESHOLD, log_add, shift_left, shift_right,
)

# kernel launches since the last reset (chip_smoke.py reads and resets them)
alpha_launches = 0
beta_launches = 0

MAX_THREADS = 1024      # threads of a block
MAX_SPT = 32            # states a thread owns at most


class CtcPlan(NamedTuple):
    spt: int            # states a thread owns
    threads: int        # threads of the block (one block a batch row)
    depth: int          # slots of the lp ring (1: no ring, a register)
    smem_bytes: int     # dynamic shared memory of either kernel


def states_per_thread(s: int) -> int:
    """1 up to 1024 states, else ceil(S/1024) rounded up to a power of
    two; 0 past MAX_SPT."""
    need = -(-s // MAX_THREADS)
    spt = 1
    while spt < need:
        spt *= 2
    return spt if spt <= MAX_SPT else 0


def smem_bytes(s: int, depth: int) -> int:
    """The kernels' shared memory (csrc/ctc_alpha_beta.cu
    ctc_smem_bytes): two exchange rows of S + 2 floats and, at depth >= 2,
    the ring of `depth` rows of S."""
    return 4 * (2 * (s + 2) + (depth * s if depth >= 2 else 0))


def ctc_plan(s: int) -> Optional[CtcPlan]:
    """Launch shape of kernels 6 and 7 at S states (the library's
    ctc_depth): the ring's depth is the largest of 8, 4, 2 whose ring fits
    beside the two rows in a block's shared memory, else 1 (each state's
    lp in a register a step ahead) while the rows fit; None where S is
    refused (the rows do not fit, or a thread would own more than 32
    states)."""
    spt, limit = states_per_thread(s), build.SMEM_LIMIT
    if s < 1 or spt == 0 or smem_bytes(s, 1) > limit:
        return None
    depth = next((p for p in (8, 4, 2) if smem_bytes(s, p) <= limit), 1)
    threads = (-(-s // spt) + 31) // 32 * 32
    return CtcPlan(spt, threads, depth, smem_bytes(s, depth))


def ctc_alpha_ref(
    lp_e: torch.Tensor, can_skip_f: torch.Tensor,
    logit_lengths: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the alpha kernel, step for step (ctc_pallas.py:
    62-85): alpha [B, T, S] float32, frozen past each row's length."""
    _, t_max, _ = lp_e.shape
    lens = logit_lengths.to(lp_e.device)[:, None]
    lane = torch.arange(lp_e.shape[2], device=lp_e.device)[None, :]
    alpha = torch.empty_like(lp_e)
    a = torch.where(lane <= 1, lp_e[:, 0], LOG_ZERO)
    alpha[:, 0] = a
    for t in range(1, t_max):
        prev2 = shift_right(a, 2) + can_skip_f
        new = lp_e[:, t] + log_add(log_add(a, shift_right(a, 1)), prev2)
        a = torch.where(t < lens, new, a)
        alpha[:, t] = a
    return alpha


def ctc_beta_ref(
    lp_e: torch.Tensor, can_skip_f: torch.Tensor,
    beta_init_row: torch.Tensor, logit_lengths: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the beta kernel, step for step (ctc_pallas.py:
    88-117): beta [B, T, S] float32, the init row at t = len-1 and
    LOG_ZERO after it."""
    _, t_max, _ = lp_e.shape
    lens = logit_lengths.to(lp_e.device)[:, None]
    beta = torch.empty_like(lp_e)
    # the skip into s+2, seen from the source state s
    skip_src = torch.where(
        shift_left(can_skip_f, 2) > LOG_ZERO_THRESHOLD, 0.0, LOG_ZERO
    )
    b = torch.full_like(beta_init_row, LOG_ZERO)
    for t in range(t_max - 1, -1, -1):
        nxt = b + lp_e[:, min(t + 1, t_max - 1)]
        rec = log_add(log_add(nxt, shift_left(nxt, 1)),
                      shift_left(nxt, 2) + skip_src)
        b = torch.where(t == lens - 1, beta_init_row,
                        torch.where(t < lens - 1, rec, LOG_ZERO))
        beta[:, t] = b
    return beta


def ctc_alpha_beta_ref(
    lp_e: torch.Tensor, can_skip_f: torch.Tensor,
    beta_init_row: torch.Tensor, logit_lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the two kernels: (alpha, beta) [B, T, S]."""
    return (ctc_alpha_ref(lp_e, can_skip_f, logit_lengths),
            ctc_beta_ref(lp_e, can_skip_f, beta_init_row, logit_lengths))


def ctc_alpha_beta(
    lp_e: torch.Tensor, can_skip_f: torch.Tensor,
    beta_init_row: torch.Tensor, logit_lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both recursions: lp_e [B, T, S] f32, can_skip_f [B, S] f32,
    beta_init_row [B, S] f32, logit_lengths [B] (any integer type) ->
    (alpha [B, T, S], beta [B, T, S]) float32."""
    global alpha_launches, beta_launches
    if lp_e.device.type == "cpu":
        return ctc_alpha_beta_ref(lp_e, can_skip_f, beta_init_row,
                                  logit_lengths)
    if lp_e.device.type != "cuda":
        raise ValueError(f"ctc_alpha_beta: unsupported device {lp_e.device}")
    bsz, t_max, s = lp_e.shape
    for name, ten, shape in (("lp_e", lp_e, (bsz, t_max, s)),
                             ("can_skip_f", can_skip_f, (bsz, s)),
                             ("beta_init_row", beta_init_row, (bsz, s))):
        if tuple(ten.shape) != shape or ten.dtype != torch.float32:
            raise ValueError(
                f"ctc_alpha_beta: {name} must be float32 {shape}, got "
                f"{ten.dtype} {tuple(ten.shape)}"
            )
        if ten.device != lp_e.device or not ten.is_contiguous():
            raise ValueError(
                f"ctc_alpha_beta: {name} must be contiguous on {lp_e.device}"
            )
    if tuple(logit_lengths.shape) != (bsz,):
        raise ValueError(f"ctc_alpha_beta: logit_lengths must be [{bsz}]")
    lens = logit_lengths.to(lp_e.device, torch.int32).contiguous()
    alpha = torch.empty_like(lp_e)
    beta = torch.empty_like(lp_e)
    if bsz == 0 or t_max == 0:
        return alpha, beta
    lib = build.load()
    stream = torch.cuda.current_stream(lp_e.device).cuda_stream
    err = lib.ctc_alpha(lp_e.data_ptr(), can_skip_f.data_ptr(),
                        lens.data_ptr(), alpha.data_ptr(), bsz, t_max, s,
                        stream)
    build.check(err, "ctc_alpha")
    alpha_launches += 1
    err = lib.ctc_beta(lp_e.data_ptr(), can_skip_f.data_ptr(),
                       beta_init_row.data_ptr(), lens.data_ptr(),
                       beta.data_ptr(), bsz, t_max, s, stream)
    build.check(err, "ctc_beta")
    beta_launches += 1
    return alpha, beta
