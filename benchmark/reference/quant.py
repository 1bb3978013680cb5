"""Precision of the reference's arithmetic.

"f32" is the reference proper: float32 everywhere, TF32 off.  The
controls put the reference in the program's place one precision below
what the configuration states: "fp8" rounds every operand of a product to
float8 e4m3 with one scale per tensor (the step below the bfloat16
products that `compute_dtype` states); "bf16" rounds every search score
and log-likelihood to bfloat16 (the step below the float32 scores of the
search).
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0   # largest finite float8 e4m3 value


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale per matrix (per [..., :, :]
    slice of a batch of matrices), back in f32."""
    scale = x.detach().abs().amax(dim=(-2, -1), keepdim=True).clamp(
        min=1e-30) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32)
    return q * scale


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b (or a batch of them) in float32, with the operands first
    rounded to fp8 under prec="fp8"."""
    if prec == "fp8":
        a, b = to_fp8(a), to_fp8(b)
    elif prec != "f32":
        raise ValueError(f"unknown precision {prec}")
    return torch.matmul(a, b)


def rnd(x: torch.Tensor, prec: str) -> torch.Tensor:
    """Search scores: x as is in float32, or rounded to bfloat16."""
    if prec == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x
