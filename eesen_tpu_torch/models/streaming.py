"""Streaming (online) acoustic model inference for unidirectional stacks
(counterpart of eesen_tpu/models/streaming.py).

The reference ships unidirectional <Lstm>/<LstmParallel> layers
(src/net/lstm-layer.h:28-265, lstm-parallel-layer.h:223) but its
online-decoding code is dead; here the uni-LSTM stack is an online ASR
path: per-layer (c, m) carries are explicit state, so features are pushed
chunk by chunk, and the log-posterior chunks feed
decoder/beam.StreamingBeamDecoder:

    sam = StreamingAcousticModel(params, cfg)       # cfg.bidirectional=False
    st = sam.start(batch_size)
    dec = StreamingBeamDecoder(graph, bcfg)
    ds = dec.start(batch_size)
    for chunk in feature_chunks:                    # [B, Tc, D]
        logits, st = sam.step(st, chunk, chunk_lengths)
        lp = torch.log_softmax(logits, dim=-1)
        ds = dec.accept(ds, lp, active_mask)
    words = dec.finish(ds)

(`step` returns logits, so the decoder gets their log_softmax.)  Chunked
output equals one offline apply_model pass over the concatenated
features: the per-row length masks freeze (c, m) through padded frames,
so rows whose stream has ended carry their state unchanged.  A carried
call runs the torch-op scan (models/bilstm._plain_scan), on the card too:
the LSTM kernels, like the JAX package's Pallas kernels, start from zero
state, so the JAX package runs its XLA scan here as well.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from eesen_tpu_torch.decoder.beam import (
    BeamSearchConfig, StreamingBeamDecoder, unpack_summary,
)
from eesen_tpu_torch.models.bilstm import _direction_scan
from eesen_tpu_torch.models.conformer import refuse
from eesen_tpu_torch.models.model import (
    AcousticModelConfig, as_tensor, check_device,
)

Params = Dict[str, object]
# per-layer (c, m), each [B, H]
Carry = List[Tuple[torch.Tensor, torch.Tensor]]


def init_stream_state(
    cfg: AcousticModelConfig, batch_size: int, device="cuda",
) -> Carry:
    refuse(cfg, "models/streaming")
    device = check_device(device)
    h = cfg.cell_dim
    return [
        (torch.zeros((batch_size, h), device=device),
         torch.zeros((batch_size, h), device=device))
        for _ in range(cfg.num_layers)
    ]


def stream_step(
    params: Params,
    carries: Carry,
    feats: torch.Tensor,     # [B, Tc, D]
    lengths: torch.Tensor,   # [B] valid frames in this chunk (0 = ended)
    cfg: AcousticModelConfig,
) -> Tuple[torch.Tensor, Carry]:
    """One chunk through the uni-LSTM stack: logits [B, Tc, V] and the
    new carries.  Each layer runs `_direction_scan` with its carry (the
    same gate math and mask freeze as the offline scan), its output is
    zeroed on padded frames, and the output affine is apply_model's."""
    if cfg.bidirectional:
        raise ValueError(
            "streaming needs a unidirectional stack "
            "(AcousticModelConfig(bidirectional=False)); BiLSTM requires "
            "the full utterance by construction"
        )
    x = feats.transpose(0, 1)                         # [Tc, B, D]
    t_c = x.shape[0]
    t_iota = torch.arange(t_c, device=x.device)[:, None]
    mask = (t_iota < lengths.to(x.device)[None, :]).to(torch.float32)
    new_carries: Carry = []
    for i in range(cfg.num_layers):
        x, carry = _direction_scan(
            params["layers"][i]["fw"], x, mask, cfg.layer_cfg(i), None,
            carry_in=carries[i], return_carry=True,
        )
        x = x * mask[:, :, None]
        new_carries.append(carry)
    cdt, f32 = cfg.compute_dtype, torch.float32
    logits = torch.matmul(
        x.to(cdt).to(f32), params["out"]["w"].to(cdt).to(f32)
    ) + params["out"]["b"]
    return logits.transpose(0, 1), new_carries


def _chunk_inputs(feats, lengths, device):
    """Features as f32 on `device`; lengths [B] (None: the whole chunk)."""
    feats = as_tensor(feats, torch.float32).to(device)
    if lengths is None:
        lengths = torch.full((feats.shape[0],), feats.shape[1],
                             dtype=torch.int64, device=device)
    else:
        lengths = as_tensor(lengths, torch.int64).to(device)
    return feats, lengths


class StreamingPipeline:
    """Online ASR with everything of a chunk on the device: the acoustic
    model chunk, log-softmax, the decoder's chunk search and the path
    summary (decoder/beam.compose_chunk_paths) run back to back with no
    copy to the host per chunk.  The per-chunk [B, K] summaries stay on
    the device; partial() and finish() copy only the ones added since the
    last call.

        pipe = StreamingPipeline(params, cfg, graph, bcfg)
        st = pipe.start(batch)
        for chunk in feature_chunks:          # [B, Tc, D]
            st = pipe.step(st, chunk, lengths)
        for words, cost in pipe.finish(st): ...

    Results equal offline apply_model + one-shot decode.  As in the JAX
    package, partial()'s `truncated` flag is set on a state dict built
    for that call and thrown away (eesen_tpu/models/streaming.py:217), so
    the caller never sees it; finish() still raises on overflow."""

    def __init__(self, params, cfg: AcousticModelConfig, graph,
                 bcfg: Optional[BeamSearchConfig] = None,
                 summary_words: Optional[int] = None, device="cuda"):
        if cfg.bidirectional:
            raise ValueError("streaming requires bidirectional=False")
        bcfg = bcfg if bcfg is not None else BeamSearchConfig()
        if bcfg.blank_skip > 0.0:
            raise ValueError(
                "StreamingPipeline runs the full search; use the "
                "unfused StreamingBeamDecoder for per-chunk blank-skip"
            )
        self.params = params
        self.cfg = cfg
        self.device = check_device(device)
        # the search, the summaries and the host-side traceback
        self._dec = StreamingBeamDecoder(graph, bcfg, summary_words,
                                         device=self.device)

    def start(self, batch_size: int) -> dict:
        dec = self._dec.start(batch_size)
        return {
            "am": init_stream_state(self.cfg, batch_size, self.device),
            "carry": dec["carry"],
            "init_olab": dec["init_olab"],
            "chunks_dev": [],     # on-device summaries, append-only
            "chunks_host": [],    # host mirror, extended lazily
            "batch": batch_size,
            "tframes": 0,
        }

    def step(self, state: dict, feats, lengths=None) -> dict:
        feats, lengths = _chunk_inputs(feats, lengths, self.device)
        logits, am = stream_step(
            self.params, state["am"], feats, lengths, self.cfg
        )
        lp = torch.log_softmax(logits, dim=-1)
        t_c = lp.shape[1]
        active = (torch.arange(t_c, device=self.device)[None, :]
                  < lengths[:, None])
        carry, summary = self._dec.summarize(state["carry"], lp, active)
        state["am"] = am
        state["carry"] = carry
        state["chunks_dev"].append(summary)   # stays on the device
        state["tframes"] += t_c
        return state

    def _fetch(self, state: dict) -> dict:
        # summaries are immutable once made: copy only the new ones
        new = state["chunks_dev"][len(state["chunks_host"]):]
        state["chunks_host"].extend(unpack_summary(s.cpu().numpy()) for s in new)
        return {
            "carry": state["carry"],
            "init_olab": state["init_olab"],
            "chunks": state["chunks_host"],
            "batch": state["batch"],
            "tframes": state["tframes"],
        }

    def partial(self, state: dict):
        return self._dec.partial(self._fetch(state))

    def finish(self, state: dict):
        return self._dec.finish(self._fetch(state))


class StreamingAcousticModel:
    """Holds params and config; see the module docstring."""

    def __init__(self, params: Params, cfg: AcousticModelConfig,
                 device="cuda"):
        refuse(cfg, "models/streaming")
        if cfg.bidirectional:
            raise ValueError("streaming requires bidirectional=False")
        self.params = params
        self.cfg = cfg
        self.device = check_device(device)

    def start(self, batch_size: int) -> Carry:
        return init_stream_state(self.cfg, batch_size, self.device)

    def step(
        self, carries: Carry, feats, lengths=None,
    ) -> Tuple[torch.Tensor, Carry]:
        feats, lengths = _chunk_inputs(feats, lengths, self.device)
        return stream_step(self.params, carries, feats, lengths, self.cfg)
