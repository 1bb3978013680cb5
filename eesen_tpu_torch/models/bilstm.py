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

Which route a direction takes (`_direction_scan`):

- with a recurrent-dropout mask (training with `recurrent_dropout > 0`),
  or with a carried state (`carry_in` / `return_carry`, the streaming
  path of models/streaming.py): the plain recurrence in torch ops with
  autograd, `_plain_scan`, on the CPU and on the card alike.  It is the
  branch the JAX package itself takes in both cases (its XLA scan,
  bilstm.py:167-233): the Pallas kernels, like kernels 1/3 and 4/5 here,
  always start from zero state and take no mask.  So it is that
  package's route, not a fallback, and on the card it launches no LSTM
  kernel, as the JAX package launches none there;
- otherwise on a CUDA tensor, when `lstm_cuda.fused_launch` takes the
  shape: the fused kernels (ops/lstm_cuda.py, csrc/lstm_fwd.cu forward,
  csrc/lstm_bwd.cu backward through `LstmDirection`), input projection
  and recurrence in one launch, m streamed in bf16 when `state_bf16`;
- otherwise on a CUDA tensor (H > 1024, or more shared memory than a
  block has): the v1 route (ops/lstm_v1_cuda.py `_v1_direction_tm`,
  kernels csrc/lstm_scan_fwd.cu and csrc/lstm_scan_bwd.cu), in bf16
  whatever `compute_dtype`, m in f32, as lstm_pallas.py:843-849 routes;
- on a CPU tensor: the plain versions of the fused kernels, which follow
  the JAX package's XLA scan branch: products in `compute_dtype`, f32
  state, `state_bf16` ignored.

`train=True` applies dropout as the JAX package does
(bilstm.py:236-317): forward dropout on the layer output, recurrent
dropout on the cell update in the `no_mem_loss` or `rnndrop` mode, each
with per-step or per-sequence masks, and twiddle (recurrent dropout on
one direction only, chosen per layer).  Masks are Bernoulli(keep)/keep,
drawn from the `rng` torch.Generator on the CPU and moved to the
device, so one seed gives the same masks on the CPU and on the card.
Forward dropout alone keeps the kernels.  A chunked run with the carried
(c, m) state equals one scan over the concatenation: the mask freeze keeps
short rows' states intact across chunk boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from eesen_tpu_torch.ops import lstm_cuda, lstm_v1_cuda

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


def split_generator(gen: torch.Generator) -> torch.Generator:
    """A new CPU generator seeded by `gen`'s next draw: the port's
    counterpart of jax.random.split, one stream per layer or step."""
    seed = int(torch.randint(0, 2**63 - 1, (), generator=gen))
    return torch.Generator().manual_seed(seed)


def _dropout_mask(
    gen: torch.Generator, rate: float, per_step: bool, b: int, t: int,
    d: int, device,
) -> torch.Tensor:
    """Bernoulli(keep) mask scaled by 1/keep, time-major [T or 1, B, D]
    (bilstm.py:236-246): per-sequence masks have a length-1 time axis, one
    draw per utterance broadcast over time.  Drawn on the CPU from `gen`,
    then moved to `device`."""
    keep = 1.0 - rate
    shape = (t, b, d) if per_step else (1, b, d)
    m = torch.rand(shape, generator=gen) < keep
    return (m.to(torch.float32) / keep).to(device)


def _plain_scan(
    p: Params, x: torch.Tensor, mask: torch.Tensor, cfg: BiLstmConfig,
    rec_drop_mask: Optional[torch.Tensor] = None,
    carry_in: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_carry: bool = False,
):
    """The recurrence in plain torch ops with autograd (bilstm.py:179-233):
    products of `compute_dtype` values summed in float32, f32 state.
    With a recurrent-dropout mask [T or 1, B, H], no_mem_loss masks the
    candidate, c = f*c_prev + mask*(i*g), and rnndrop the cell,
    c = mask*(f*c_prev + i*g).  The state starts from `carry_in` (c, m),
    each [B, H], or zeros.  Returns m [T, B, H] f32, zero at padded
    steps, and with `return_carry` also the final (c, m)."""
    t_max, b, d = x.shape
    h = cfg.cell_dim
    cdt, f32 = cfg.compute_dtype, torch.float32
    xw = torch.matmul(
        x.to(cdt).to(f32), p["w_gifo_x"].reshape(d, 4 * h).to(cdt).to(f32)
    ) + p["bias"].reshape(4 * h)                               # [T, B, 4H]
    w_m = p["w_gifo_m"].reshape(h, 4 * h).to(cdt).to(f32)
    ph_i, ph_f, ph_o = p["phole_i_c"], p["phole_f_c"], p["phole_o_c"]
    rnndrop = cfg.recurrent_dropout_mode == "rnndrop"
    if carry_in is None:
        c = m_carry = torch.zeros((b, h), dtype=f32, device=x.device)
    else:
        c, m_carry = (v.to(f32) for v in carry_in)
    ms = []
    for t in range(t_max):
        rd = None if rec_drop_mask is None else rec_drop_mask[
            t if rec_drop_mask.shape[0] > 1 else 0]
        gifo = xw[t] + torch.matmul(m_carry.to(cdt).to(f32), w_m)
        g = torch.tanh(gifo[:, 0 * h:1 * h])
        i = torch.sigmoid(gifo[:, 1 * h:2 * h] + c * ph_i)
        f = torch.sigmoid(gifo[:, 2 * h:3 * h] + c * ph_f)
        cand = i * g
        if rd is not None and not rnndrop:
            cand = cand * rd
        c_new = f * c + cand
        if rd is not None and rnndrop:
            c_new = c_new * rd
        o = torch.sigmoid(gifo[:, 3 * h:4 * h] + c_new * ph_o)
        mt = mask[t][:, None]
        m = o * torch.tanh(c_new) * mt   # padded steps emit zeros
        c = c_new * mt + c * (1.0 - mt)
        m_carry = m + m_carry * (1.0 - mt)
        ms.append(m)
    ms = torch.stack(ms) if ms else torch.zeros_like(xw[..., :h])
    if return_carry:
        return ms, (c, m_carry)
    return ms


def _reverse_by_length(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence within its own valid span: x [B, T, D]; the
    padded tail stays in place.  (The layers flip whole arrays instead;
    kept for the JAX package's API.)"""
    b, t_max, _ = x.shape
    t = torch.arange(t_max, device=x.device).expand(b, t_max)
    n = lengths.to(x.device).long()[:, None]
    idx = torch.where(t < n, n - 1 - t, t)
    return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def _direction_scan(
    p: Params, x: torch.Tensor, mask: torch.Tensor, cfg: BiLstmConfig,
    rec_drop_mask: Optional[torch.Tensor] = None,
    carry_in: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_carry: bool = False,
):
    """One direction's recurrence, time-major: x [T, B, D] (already
    time-flipped for the backward direction), mask [T, B] float 0/1,
    rec_drop_mask [T or 1, B, H] or None; returns m [T, B, H] (f32, or
    bf16 from the fused kernel under state_bf16), zero at padded steps.
    `carry_in` (c, m) [B, H] starts the state there and `return_carry`
    also returns the final (c, m): such a call, like one with a dropout
    mask, runs `_plain_scan` (module docstring).  Otherwise the route is
    chosen as the module docstring says.  The weights go in as float32:
    the wrappers cast them to the compute dtype, and their gradients stay
    float32."""
    if rec_drop_mask is not None or carry_in is not None or return_carry:
        return _plain_scan(p, x, mask, cfg, rec_drop_mask, carry_in,
                           return_carry)
    t_max, b, d = x.shape
    h = cfg.cell_dim
    if x.is_cuda and lstm_cuda.fused_launch(b, d, h) is None:
        m = lstm_v1_cuda._v1_direction_tm(
            x, mask, p["w_gifo_x"], p["bias"], p["w_gifo_m"],
            p["phole_i_c"], p["phole_f_c"], p["phole_o_c"],
        )
        return m * mask[:, :, None]
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
    rng: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Apply one BiLSTM layer, time-major: x [T, B, D] -> [T, B, 2H]
    ([T, B, H] when unidirectional), zero at padded steps.  With `train`,
    dropout and twiddle as configured, their masks drawn from `rng` (a CPU
    torch.Generator) in the JAX package's order: recurrent fw, recurrent
    bw, the twiddle pick, then the forward-dropout mask."""
    t_max, b = x.shape[:2]
    t_iota = torch.arange(t_max, device=x.device)[:, None]
    mask = (t_iota < lengths.to(x.device)[None, :]).to(torch.float32)

    rd_fw = rd_bw = None
    if train and (cfg.recurrent_dropout > 0.0 or cfg.forward_dropout > 0.0):
        if rng is None:
            raise ValueError("dropout needs an rng (a torch.Generator)")
    if train and cfg.recurrent_dropout > 0.0:
        draw = lambda: _dropout_mask(
            rng, cfg.recurrent_dropout, cfg.recurrent_step_dropout, b,
            t_max, cfg.cell_dim, x.device)
        rd_fw, rd_bw = draw(), draw()
        if cfg.twiddle and cfg.bidirectional:
            # recurrent dropout on exactly one direction, chosen at random
            # (bilstm-parallel-layer.h:385-405); the other takes a ones
            # mask, so both run the dropout scan, as in JAX
            if bool(torch.rand((), generator=rng) < 0.5):
                rd_bw = torch.ones_like(rd_bw)
            else:
                rd_fw = torch.ones_like(rd_fw)

    m_fw = _direction_scan(params["fw"], x, mask, cfg, rd_fw)
    if cfg.bidirectional:
        m_bw_rev = _direction_scan(
            params["bw"], torch.flip(x, dims=(0,)),
            torch.flip(mask, dims=(0,)), cfg, rd_bw,
        )
        y = torch.cat([m_fw, torch.flip(m_bw_rev, dims=(0,))], dim=-1)
    else:
        y = m_fw
    if train and cfg.forward_dropout > 0.0:
        y = y * _dropout_mask(rng, cfg.forward_dropout,
                              cfg.forward_step_dropout, b, t_max,
                              cfg.output_dim, x.device)
    return y * mask[:, :, None]


def bilstm_layer(
    params: Dict[str, Params],
    x: torch.Tensor,
    lengths: torch.Tensor,
    cfg: BiLstmConfig,
    *,
    train: bool = False,
    rng: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Batch-major wrapper of `bilstm_layer_tm`: x [B, T, D] ->
    [B, T, 2H] ([B, T, H] when unidirectional), on x's device, with the
    same `train` / `rng` contract.  The model stack runs time-major end
    to end."""
    y = bilstm_layer_tm(params, x.transpose(0, 1), lengths, cfg,
                        train=train, rng=rng)
    return y.transpose(0, 1)
