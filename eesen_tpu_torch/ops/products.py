"""Products of compute-dtype operands into float32 results, as the
Conformer (models/conformer.py, ops/rel_attention.py) takes them: the
operands are rounded to the configuration's compute dtype, the product
accumulates in f32 and its result stays f32, in the forward and the
backward pass alike.

On the GPU a bfloat16 product is cuBLAS's with an f32 output
(`torch.mm` / `torch.bmm` with `out_dtype`); elsewhere, and for f32
operands, it is the f32 product of the operands' values, the same
numbers up to the order of summation.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last two axes (leading axes equal, batched) in f32;
    a and b of one dtype."""
    if not a.is_cuda or a.dtype == F32:
        return torch.matmul(a.to(F32), b.to(F32))
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=F32)
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                    b.reshape(-1, *b.shape[-2:]), out_dtype=F32)
    return out.view(*lead, a.shape[-2], b.shape[-1])


class _Linear(torch.autograd.Function):
    """x W^T with both operands in `cdt`, into f32; dx = g W and
    dW = g^T x with g in `cdt`, into f32 (dx then in x's dtype)."""

    @staticmethod
    def forward(ctx, x, w, cdt):
        xc = x.reshape(-1, x.shape[-1]).to(cdt)
        wc = w.to(cdt)
        ctx.save_for_backward(xc, wc)
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return mm32(xc, wc.t()).view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        gc = g.reshape(-1, g.shape[-1]).to(wc.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = mm32(gc, wc).view(ctx.x_shape).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dw = mm32(gc.t(), xc)
        return dx, dw, None


def linear32(x: torch.Tensor, w: torch.Tensor,
             cdt: torch.dtype) -> torch.Tensor:
    """x [..., in] W [out, in]^T in f32 from operands in `cdt`."""
    return _Linear.apply(x, w, cdt)


class _Rounded(torch.autograd.Function):
    """x's values rounded to `cdt`, in x's dtype; the gradient passes
    unrounded."""

    @staticmethod
    def forward(ctx, x, cdt):
        return x.to(cdt).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def rounded(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """x rounded to `cdt` as an operand (nothing to do for f32)."""
    return x if cdt == x.dtype else _Rounded.apply(x, cdt)
