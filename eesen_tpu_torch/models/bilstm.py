"""Bidirectional LSTM layers in PyTorch (counterpart of
eesen_tpu/models/bilstm.py).

The reference's BiLSTM acoustic-model layer (src/net/bilstm-layer.h
parameters and step loops; src/net/bilstm-parallel-layer.h masked
multi-stream propagation), time-major [T, B, D] with per-sequence length
masks:

- GIFO gate packing (g cell candidate, i input, f forget, o output; src/
  net/lstm-layer.h:70-73) with diagonal peepholes from the cell to the
  i/f/o gates.  Weights are stored gate-structured, [D, 4, H] and
  [H, 4, H], name for name with the JAX parameters.
- A padded step (mask 0) freezes the c and m state; the layer output is
  zero there.
- The backward direction runs the forward recurrence on the whole-array
  time flip (padding frames first: the mask keeps the zero state through
  the padded prefix).

On a CUDA tensor `_direction_scan` runs the fused kernel (ops/lstm_cuda.py,
csrc/lstm_fwd.cu): input projection and recurrence in one launch, m
streamed in bf16 when `state_bf16`.  On a CPU tensor it runs the plain
recurrence, which follows the JAX package's XLA scan branch: products in
`compute_dtype`, f32 state, `state_bf16` ignored.  Gradients come from
`lstm_cuda.LstmDirection`: the backward kernel csrc/lstm_bwd.cu on the
card, its plain version on the CPU.

`train=True` runs the layer as the JAX package trains it without dropout
(the WSJ recipe uses none).  Forward dropout, recurrent dropout and
twiddle raise NotImplementedError: the JAX package runs recurrent dropout
through its XLA scan, with no kernel, and the port has not taken it yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from eesen_tpu_torch.ops import lstm_cuda

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BiLstmConfig:
    input_dim: int
    cell_dim: int
    param_range: float = 0.1       # uniform init ±range (net/layer.cc InitData)
    fgate_bias: float = 0.0        # forget-gate bias init (<FgateBias>)
    # dropout (bilstm-parallel-layer.h:46-95): training only
    forward_dropout: float = 0.0
    recurrent_dropout: float = 0.0
    forward_step_dropout: bool = False
    recurrent_step_dropout: bool = False
    recurrent_dropout_mode: str = "no_mem_loss"   # or "rnndrop"
    twiddle: bool = False
    # dtype of the matmul operands; state and sums stay float32
    compute_dtype: torch.dtype = torch.bfloat16
    # False = unidirectional <Lstm>/<LstmParallel>
    bidirectional: bool = True
    # the CUDA kernel streams its m output in bf16 (carries stay f32)
    state_bf16: bool = True

    @property
    def output_dim(self) -> int:
        return (2 if self.bidirectional else 1) * self.cell_dim


def _init_direction(
    gen: torch.Generator, cfg: BiLstmConfig, device,
) -> Params:
    h, d = cfg.cell_dim, cfg.input_dim
    r = cfg.param_range

    def u(*shape):
        x = torch.rand(shape, generator=gen, dtype=torch.float32)
        return ((x * 2.0 - 1.0) * r).to(device)

    w_x = u(d, 4, h)
    w_m = u(h, 4, h)
    bias = u(4, h)
    bias[2] += cfg.fgate_bias       # GIFO: forget gate is index 2
    return {
        "w_gifo_x": w_x,
        "w_gifo_m": w_m,
        "bias": bias,
        "phole_i_c": u(h),
        "phole_f_c": u(h),
        "phole_o_c": u(h),
    }


def init_bilstm_layer(
    gen: torch.Generator, cfg: BiLstmConfig, device="cuda",
) -> Dict[str, Params]:
    """Uniform ±param_range init from `gen` (a CPU torch.Generator)."""
    if not cfg.bidirectional:
        return {"fw": _init_direction(gen, cfg, device)}
    return {
        "fw": _init_direction(gen, cfg, device),
        "bw": _init_direction(gen, cfg, device),
    }


def _direction_scan(
    p: Params, x: torch.Tensor, mask: torch.Tensor, cfg: BiLstmConfig,
) -> torch.Tensor:
    """One direction's recurrence, time-major: x [T, B, D] (already
    time-flipped for the backward direction), mask [T, B] float 0/1;
    returns m [T, B, H] (f32, or bf16 from the card under state_bf16),
    zero at padded steps.  The weights go in as float32: the wrapper casts
    them to the compute dtype, and their gradients stay float32."""
    d, h = cfg.input_dim, cfg.cell_dim
    cdt = cfg.compute_dtype
    ph = torch.stack([p["phole_i_c"], p["phole_f_c"], p["phole_o_c"]])
    m = lstm_cuda.lstm_direction(
        x.to(cdt).contiguous(),
        mask.contiguous(),
        p["w_gifo_x"].reshape(d, 4 * h).contiguous(),
        p["bias"].reshape(4 * h).contiguous(),
        p["w_gifo_m"].reshape(h, 4 * h).contiguous(),
        ph.contiguous(),
        # the CPU path keeps f32 state, as the JAX package's XLA scan does
        state_bf16=cfg.state_bf16 and x.is_cuda,
    )
    return m * mask[:, :, None]


def bilstm_layer_tm(
    params: Dict[str, Params],
    x: torch.Tensor,
    lengths: torch.Tensor,
    cfg: BiLstmConfig,
    *,
    train: bool = False,
) -> torch.Tensor:
    """Apply one BiLSTM layer, time-major: x [T, B, D] -> [T, B, 2H]
    ([T, B, H] when unidirectional), zero at padded steps.  `train` only
    matters for dropout and twiddle, which are not ported yet."""
    if train and (cfg.forward_dropout > 0.0 or cfg.recurrent_dropout > 0.0
                  or cfg.twiddle):
        raise NotImplementedError(
            "training with dropout or twiddle is not ported yet"
        )
    t_max = x.shape[0]
    t_iota = torch.arange(t_max, device=x.device)[:, None]
    mask = (t_iota < lengths.to(x.device)[None, :]).to(torch.float32)

    m_fw = _direction_scan(params["fw"], x, mask, cfg)
    if cfg.bidirectional:
        m_bw_rev = _direction_scan(
            params["bw"], torch.flip(x, dims=(0,)),
            torch.flip(mask, dims=(0,)), cfg,
        )
        y = torch.cat([m_fw, torch.flip(m_bw_rev, dims=(0,))], dim=-1)
    else:
        y = m_fw
    return y * mask[:, :, None]

