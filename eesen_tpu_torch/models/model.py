"""Acoustic model: a stack of BiLSTM layers + affine output projection
(counterpart of eesen_tpu/models/model.py), or a Conformer
(models/conformer.py), chosen by the configuration's type.

Mirrors the reference's topology (asr_egs/wsj/utils/model_topo.py emits
N x <BiLstmParallel> + <AffineTransform> + <Softmax>).  `apply_model`
returns pre-softmax logits; the decoder side applies log-softmax.

Parameters are a plain dict of tensors with the JAX package's pytree
layout, `{"layers": [{"fw": {...}, "bw": {...}}, ...], "out": {"w", "b"}}`,
so `params_from_jax` converts name for name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from eesen_tpu_torch.models.bilstm import (
    BiLstmConfig, bilstm_layer_tm, init_bilstm_layer, split_generator,
)
from eesen_tpu_torch.models import conformer
from eesen_tpu_torch.models.conformer import ConformerConfig

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AcousticModelConfig:
    """Defaults follow the WSJ recipe: 4 x 320-cell BiLSTM over 120-dim
    (40 fbank + deltas) input, 72 targets (asr_egs/wsj/run_ctc_phn.sh)."""

    input_dim: int = 120
    cell_dim: int = 320
    num_layers: int = 4
    num_targets: int = 72          # vocab incl. blank at index 0
    param_range: float = 0.1
    fgate_bias: float = 0.0
    forward_dropout: float = 0.0
    recurrent_dropout: float = 0.0
    forward_step_dropout: bool = False
    recurrent_step_dropout: bool = False
    recurrent_dropout_mode: str = "no_mem_loss"
    twiddle: bool = False
    compute_dtype: torch.dtype = torch.bfloat16
    bidirectional: bool = True
    state_bf16: bool = True

    @property
    def layer_output_dim(self) -> int:
        return (2 if self.bidirectional else 1) * self.cell_dim

    def layer_cfg(self, index: int) -> BiLstmConfig:
        in_dim = self.input_dim if index == 0 else self.layer_output_dim
        return BiLstmConfig(
            input_dim=in_dim,
            bidirectional=self.bidirectional,
            state_bf16=self.state_bf16,
            cell_dim=self.cell_dim,
            param_range=self.param_range,
            fgate_bias=self.fgate_bias,
            forward_dropout=self.forward_dropout,
            recurrent_dropout=self.recurrent_dropout,
            forward_step_dropout=self.forward_step_dropout,
            recurrent_step_dropout=self.recurrent_step_dropout,
            recurrent_dropout_mode=self.recurrent_dropout_mode,
            twiddle=self.twiddle,
            compute_dtype=self.compute_dtype,
        )


def check_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device must exist: the
    port never falls back to the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    return device


def as_tensor(x, dtype: torch.dtype) -> torch.Tensor:
    """x as a tensor of `dtype` (host arrays are copied, never aliased)."""
    if torch.is_tensor(x):
        return x.to(dtype)
    return torch.tensor(np.asarray(x), dtype=dtype)


def init_model(
    gen: torch.Generator, cfg: AcousticModelConfig, device="cuda",
) -> Params:
    """Uniform ±param_range parameters drawn from `gen` (a CPU
    torch.Generator), placed on `device` (a Conformer's:
    `conformer.init_conformer`)."""
    device = check_device(device)
    if isinstance(cfg, ConformerConfig):
        return conformer.init_conformer(gen, cfg, device)
    layers: List[Params] = [
        init_bilstm_layer(gen, cfg.layer_cfg(i), device)
        for i in range(cfg.num_layers)
    ]
    r = cfg.param_range

    def u(*shape):
        x = torch.rand(shape, generator=gen, dtype=torch.float32)
        return ((x * 2.0 - 1.0) * r).to(device)

    out = {"w": u(cfg.layer_output_dim, cfg.num_targets),
           "b": u(cfg.num_targets)}
    return {"layers": layers, "out": out}


def params_from_jax(tree: Params, device="cuda") -> Params:
    """The JAX package's parameter pytree (leaves as numpy arrays, or
    anything np.asarray takes) as float32 tensors on `device`, name for
    name."""
    device = check_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(
            np.array(node, dtype=np.float32, copy=True)
        ).to(device)

    return conv(tree)


def apply_model(
    params: Params,
    feats: torch.Tensor,
    lengths: torch.Tensor,
    cfg: AcousticModelConfig,
    *,
    train: bool = False,
    rng: Optional[torch.Generator] = None,
    buffers_out: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """feats [B, T, input_dim] -> logits [B, T, num_targets] (f32).

    A Conformer (`conformer.apply_conformer`) gives [B, T', num_targets]
    over the subsampled frames (`output_lengths`) and takes no `rng` (it
    has no dropout); in training its updated BatchNorm statistics go to
    `buffers_out`.  The LSTM stack has no buffers.

    The stack runs time-major (one transpose in, one out), as the JAX
    package does.  The output affine is a float32 torch.matmul of the
    compute-dtype operands (TF32 is off).  Gradients flow to `params`
    when they require grad (the LSTM through its backward kernel).
    With `train`, dropout draws its masks from `rng` (a CPU
    torch.Generator, needed when the config has dropout), split into one
    generator per layer as the JAX package splits its key."""
    if isinstance(cfg, ConformerConfig):
        return conformer.apply_conformer(params, feats, lengths, cfg,
                                         train=train, buffers_out=buffers_out)
    x = feats.transpose(0, 1)                             # [T, B, D]
    for i in range(cfg.num_layers):
        lrng = None if rng is None else split_generator(rng)
        x = bilstm_layer_tm(
            params["layers"][i], x, lengths, cfg.layer_cfg(i), train=train,
            rng=lrng,
        )
    cdt = cfg.compute_dtype
    f32 = torch.float32
    logits = torch.matmul(
        x.to(cdt).to(f32), params["out"]["w"].to(cdt).to(f32)
    ) + params["out"]["b"]
    return logits.transpose(0, 1)                          # [B, T, V]


def output_lengths(cfg, lengths):
    """The frames of the model's output for input lengths (a tensor or a
    numpy array): the Conformer's subsampling arithmetic; the LSTM's are
    its input's, the same object returned."""
    if isinstance(cfg, ConformerConfig):
        return conformer.output_lengths(lengths)
    return lengths


def model_num_params(params: Params) -> int:
    """Trained parameters (a Conformer's BatchNorm buffers not counted)."""
    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for k, v in node.items()
                       if k != conformer.BUFFERS)
        if isinstance(node, (list, tuple)):
            return sum(count(v) for v in node)
        return int(node.numel())

    return count(params)
