"""Serving entry points: features -> posteriors -> WFST beam decode ->
best paths (counterpart of the decode stage of eesen_tpu/recipes/run.py,
`RecipeRun._posteriors`, `_run_search` and `decode`).

    params = init_model(gen, model_cfg)                # or params_from_jax
    lp = posteriors(params, model_cfg, feats, lengths, log_priors)
    hyps = decode(params, model_cfg, graph, feats_by_utt, log_priors,
                  BeamSearchConfig(beam=16.0, max_active=512))

Everything runs on `device` ("cuda" unless the caller asks for "cpu"):
the BiLSTM stack through the fused LSTM kernel, the search through the
recombination kernel.  With `BeamSearchConfig(blank_skip=0.98)`, as every
recipe decodes, blank-dominated runs of the prior-divided posteriors are
merged first (decoder/frame_skip.py) and the search runs on the compacted
frames.  Streaming is models/streaming.py; greedy decoding
decoder/greedy.py.  Training is training/trainer.py; features and WER
scoring are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from eesen_tpu_torch.decoder.beam import (
    BeamOutputs, BeamSearchConfig, DeviceGraph, make_beam_decoder, traceback,
)
from eesen_tpu_torch.decoder.frame_skip import compact_blank_frames
from eesen_tpu_torch.decoder.graph_compile import CompiledGraph
from eesen_tpu_torch.models.model import (
    AcousticModelConfig, apply_model, as_tensor, check_device,
)
from eesen_tpu_torch.models.priors import subtract_priors
from eesen_tpu_torch.utils.logging import get_logger

log = get_logger("recipes.run")


def posteriors(
    params,
    cfg: AcousticModelConfig,
    feats,
    lengths,
    log_priors: Optional[np.ndarray] = None,
    device="cuda",
) -> torch.Tensor:
    """Model log-posteriors (prior-divided when log_priors is given):
    feats [B, T, D], lengths [B] -> [B, T, V] float32 on `device`
    (apply_model, log_softmax, subtract_priors)."""
    device = check_device(device)
    x = as_tensor(feats, torch.float32).to(device)
    lens = as_tensor(lengths, torch.int64).to(device)
    logits = apply_model(params, x, lens, cfg)
    lp = torch.log_softmax(logits, dim=-1)
    if log_priors is not None:
        lp = subtract_priors(lp, log_priors)
    return lp


def _pad_chunk(
    feats: Dict[str, np.ndarray], chunk: List[str], time_bucket: int,
    batch_pad: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Chunk features padded to [max(len(chunk), batch_pad), T, D], T
    rounded up to time_bucket; padded rows have length 0."""
    t_max = max(feats[k].shape[0] for k in chunk)
    if time_bucket > 1:
        t_max = -(-t_max // time_bucket) * time_bucket
    b = max(len(chunk), batch_pad)
    arr = np.zeros((b, t_max, feats[chunk[0]].shape[1]), np.float32)
    lens = np.zeros(b, np.int32)
    for j, k in enumerate(chunk):
        arr[j, : len(feats[k])] = feats[k]
        lens[j] = len(feats[k])
    return arr, lens


def run_search(
    params, model_cfg: AcousticModelConfig, graph: CompiledGraph,
    feats: Dict[str, np.ndarray], log_priors: Optional[np.ndarray],
    cfg: BeamSearchConfig, batch_size: int = 8, time_bucket: int = 128,
    device="cuda",
) -> Iterator[Tuple[List[str], torch.Tensor, np.ndarray, BeamOutputs]]:
    """Batched beam search over the utterances of `feats`, longest first;
    yields (chunk keys, log-posteriors, lengths, BeamOutputs).  With
    cfg.blank_skip > 0 the prior-divided log-posteriors are compacted
    first (decoder/frame_skip.py, bucket cfg.blank_skip_bucket), and the
    yielded lp and lengths are the compacted ones the search saw.  A
    chunk whose per-frame word buffer overflowed is decoded once more
    with doubled max_olabels."""
    device = check_device(device)
    decoder = make_beam_decoder(graph, cfg)
    dg = DeviceGraph.put(graph, device=device)
    keys = sorted(feats, key=lambda k: (-feats[k].shape[0], k))
    for i in range(0, len(keys), batch_size):
        chunk = keys[i : i + batch_size]
        arr, lens = _pad_chunk(feats, chunk, time_bucket, batch_size)
        lp = posteriors(params, model_cfg, arr, lens, log_priors, device)
        if cfg.blank_skip > 0.0:
            cf = compact_blank_frames(lp, lens, cfg.blank_skip,
                                      bucket=cfg.blank_skip_bucket)
            lp = cf.loglikes
            lens = cf.lengths.cpu().numpy()
        out = decoder(lp, lens, dg)
        n_over = int(out.overflow.sum())
        if n_over > 0:
            log.warning(
                "beam search dropped %d olabels (max_olabels=%d); "
                "re-decoding chunk with doubled capacity",
                n_over, cfg.max_olabels,
            )
            wide = dataclasses.replace(cfg, max_olabels=cfg.max_olabels * 2)
            out = make_beam_decoder(graph, wide)(lp, lens, dg)
        yield chunk, lp, lens, out


def decode(
    params, model_cfg: AcousticModelConfig, graph: CompiledGraph,
    feats: Dict[str, np.ndarray], log_priors: Optional[np.ndarray] = None,
    cfg: BeamSearchConfig = BeamSearchConfig(), batch_size: int = 8,
    time_bucket: int = 128, device="cuda",
) -> Dict[str, Tuple[List[int], float]]:
    """Best-path decode of every utterance: {key: (word ids, cost)}."""
    hyps: Dict[str, Tuple[List[int], float]] = {}
    for chunk, _, lens, out in run_search(
        params, model_cfg, graph, feats, log_priors, cfg, batch_size,
        time_bucket, device,
    ):
        # zip: the batch may carry padded zero-length rows past chunk
        for k, res in zip(chunk, traceback(out, lens, graph.final_weight)):
            hyps[k] = res
    return hyps
