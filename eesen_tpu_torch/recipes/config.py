"""Per-corpus recipe configurations, matching the reference's published
hyperparameters (sources cited per entry).

These are the knobs the reference spreads over run_ctc_*.sh +
steps/train_ctc_parallel.sh + steps/decode_ctc_lat.sh; `RecipeConfig`
gathers them so a corpus run is config + data dirs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from eesen_tpu_torch.decoder.beam import BeamSearchConfig
from eesen_tpu_torch.frontend.features import FbankOptions, FrameOptions, MelOptions
from eesen_tpu_torch.frontend.pipeline import FeaturePipelineConfig
from eesen_tpu_torch.models.model import AcousticModelConfig
from eesen_tpu_torch.training.batching import BatchConfig
from eesen_tpu_torch.training.optim import OptimizerConfig
from eesen_tpu_torch.training.schedule import NewbobConfig


@dataclasses.dataclass(frozen=True)
class RecipeConfig:
    name: str
    dict_type: str                  # phn | char
    fbank: FbankOptions
    pipeline: FeaturePipelineConfig
    model: AcousticModelConfig      # num_targets filled per lang dir
    optimizer: OptimizerConfig
    newbob: NewbobConfig
    batch: BatchConfig
    decode: BeamSearchConfig
    acwt_sweep: Tuple[float, ...] = tuple(
        round(0.5 + 0.1 * i, 1) for i in range(6)
    )  # local/score.sh:44 sweeps acwt 0.5..1.0
    # blank-skip parity guard: before a scoring pass trusts blank-run
    # merging (decode.blank_skip > 0), decode this many randomly sampled
    # utterances BOTH ways and require word-identical best paths; on
    # mismatch the pass falls back to the full (non-skipping) decode.
    # 0 disables the guard.  The merge is exact only when each blank run
    # carries <= 1 label transition (frame_skip.py), so the guard makes
    # the default defensible on content where that premise fails.
    # Default 64: at the ~3% per-utterance mismatch rate measured on the
    # round-3 stress eval (9/300 utts differed), 64 samples detect with
    # ~86% power per pass (16 gave ~39%; 4 only ~11%), every mismatch
    # downgrades the whole pass to the full search, and the verdict is
    # cached per eval set within a RecipeRun so repeated sweeps pay the
    # double decode once.
    blank_skip_guard: int = 64


_FBANK40 = FbankOptions(
    frame_opts=FrameOptions(),          # 25ms/10ms povey, dither 1.0
    mel_opts=MelOptions(num_bins=40),   # conf/fbank.conf --num-mel-bins=40
)

_DELTAS = FeaturePipelineConfig(norm_vars=True, delta_order=2)

# splice ±1 then every 3rd frame, then deltas — the 30ms frame-rate trick
# (tedlium/v2-30ms/run_ctc_phn.sh:80-84, librispeech --splice/--skip-frames)
_SPLICE_SKIP3 = FeaturePipelineConfig(
    norm_vars=True, splice_left=1, splice_right=1, subsample_n=3,
    delta_order=2,
)

_SGD = OptimizerConfig(algorithm="sgd", momentum=0.9, max_grad=50.0)


def _model(layers: int, cell: int, input_dim: int, fgate: float = 0.0,
           **kw) -> AcousticModelConfig:
    return AcousticModelConfig(
        input_dim=input_dim, cell_dim=cell, num_layers=layers,
        num_targets=-1, param_range=0.1, fgate_bias=fgate, **kw
    )


# All decode configs enable blank-run-merged frame skipping
# (decoder/frame_skip.py, threshold 0.98).  The merge is an
# APPROXIMATION: it is exact only when each blank run carries <= 1
# label transition, and measurement shows that premise can fail —
# 9/300 stress-eval utterances differed (7.51% vs 7.46% WER, round 3),
# and the round-4 stress-v2 guard caught a live mismatch.  The
# blank_skip_guard below (skip-vs-full word-identity sampling before
# every sweep, auto-fallback to the full search on any mismatch) is
# what makes the default defensible; decode cost drops by the model's
# blank rate (2-8x).
RECIPES = {
    # WSJ phoneme CTC (asr_egs/wsj/run_ctc_phn.sh:66-86, RESULTS:11 -> 7.28%)
    "wsj_phn": RecipeConfig(
        name="wsj_phn", dict_type="phn", fbank=_FBANK40, pipeline=_DELTAS,
        model=_model(4, 320, 120),
        optimizer=_SGD,
        newbob=NewbobConfig(learn_rate=4e-5, max_iters=25),
        batch=BatchConfig(num_sequence=10, frame_limit=25000),
        decode=BeamSearchConfig(beam=17.0, max_active=5000,
                                acoustic_scale=0.9, lattice_beam=8.0,
                                blank_skip=0.98),
    ),
    # WSJ character CTC (run_ctc_char.sh; RESULTS:18/25)
    "wsj_char": RecipeConfig(
        name="wsj_char", dict_type="char", fbank=_FBANK40, pipeline=_DELTAS,
        model=_model(4, 320, 120),
        optimizer=_SGD,
        newbob=NewbobConfig(learn_rate=4e-5, max_iters=25),
        batch=BatchConfig(num_sequence=10, frame_limit=25000),
        decode=BeamSearchConfig(beam=17.0, max_active=5000,
                                acoustic_scale=0.9, lattice_beam=8.0,
                                blank_skip=0.98),
    ),
    # Switchboard 300h phoneme (swbd/v1/run_ctc_phn.sh:138-149: 5x320,
    # fgate-bias 1.0; RESULTS:12 -> 15.0%)
    "swbd_phn": RecipeConfig(
        name="swbd_phn", dict_type="phn", fbank=_FBANK40, pipeline=_DELTAS,
        model=_model(5, 320, 120, fgate=1.0),
        optimizer=_SGD,
        newbob=NewbobConfig(learn_rate=4e-5, max_iters=25),
        batch=BatchConfig(num_sequence=10, frame_limit=25000),
        decode=BeamSearchConfig(beam=17.0, max_active=5000,
                                acoustic_scale=0.9, lattice_beam=8.0,
                                blank_skip=0.98),
    ),
    # TEDLIUM v2 30ms frame rate (tedlium/v2-30ms/run_ctc_phn.sh:63-85:
    # 5x320, fgate 1.0, splice+subsample x3; RESULTS -> dev 19.6%)
    "tedlium_phn_30ms": RecipeConfig(
        name="tedlium_phn_30ms", dict_type="phn", fbank=_FBANK40,
        pipeline=_SPLICE_SKIP3,
        model=_model(5, 320, 360, fgate=1.0),  # 40 x3 splice x3 deltas
        optimizer=_SGD,
        newbob=NewbobConfig(learn_rate=4e-5, max_iters=25),
        batch=BatchConfig(num_sequence=10, frame_limit=25000),
        decode=BeamSearchConfig(beam=17.0, max_active=5000,
                                acoustic_scale=0.6, lattice_beam=8.0,
                                blank_skip=0.98),
    ),
    # HKUST Mandarin characters (hkust/v1/run_ctc_char.sh:63-74: 5x320,
    # fgate 1.0; RESULTS -> CER 39.70 fbank / 38.67 +pitch)
    "hkust_char": RecipeConfig(
        name="hkust_char", dict_type="char", fbank=_FBANK40,
        pipeline=_DELTAS,
        model=_model(5, 320, 120, fgate=1.0),
        optimizer=_SGD,
        newbob=NewbobConfig(learn_rate=4e-5, max_iters=25),
        batch=BatchConfig(num_sequence=10, frame_limit=25000),
        decode=BeamSearchConfig(beam=17.0, max_active=5000,
                                acoustic_scale=0.9, lattice_beam=8.0,
                                blank_skip=0.98),
    ),
    # LibriSpeech 100h char + NML-sequence dropout + augmentation
    # (librispeech/run_nml_seq_fw_seq_tw.sh:92-150: 4x640,
    # splice ±1 + skip 3, dropout; RESULTS -> test_clean 8.15%)
    "librispeech_char": RecipeConfig(
        name="librispeech_char", dict_type="char", fbank=_FBANK40,
        pipeline=_SPLICE_SKIP3,
        model=_model(
            4, 640, 360,
            # nml_seq_fw_seq_tw: no-mem-loss recurrent dropout with
            # per-sequence masks, forward sequence dropout, twiddle
            # (config/nnet.proto.nml_seq_fw_seq_tw)
            forward_dropout=0.2, recurrent_dropout=0.2,
            forward_step_dropout=False, recurrent_step_dropout=False,
            recurrent_dropout_mode="no_mem_loss", twiddle=True,
        ),
        optimizer=_SGD,
        newbob=NewbobConfig(learn_rate=4e-5, max_iters=25),
        batch=BatchConfig(num_sequence=20, frame_limit=25000),
        decode=BeamSearchConfig(beam=17.0, max_active=5000,
                                acoustic_scale=0.9, lattice_beam=8.0,
                                blank_skip=0.98),
    ),
}


def pipeline_input_dim(cfg: RecipeConfig) -> int:
    """Model input dim implied by fbank dims + pipeline."""
    d = cfg.fbank.mel_opts.num_bins
    d *= 1 + cfg.pipeline.splice_left + cfg.pipeline.splice_right
    d *= 1 + cfg.pipeline.delta_order
    return d
