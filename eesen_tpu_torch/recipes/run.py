"""The recipe driver and its serving entry points (counterpart of
eesen_tpu/recipes/run.py).

`RecipeRun` is the Python equivalent of the reference's per-corpus
run_ctc_*.sh pipeline (reference: asr_egs/wsj/run_ctc_phn.sh:21-97):
  1. lang build (tokens/words/T/L) + label prep
  2. features (batched fbank on the device -> per-speaker CMVN ->
     pipeline on the host)
  3. CTC training with the newbob schedule (training/trainer.py)
  4. TLG build + batched decode on the device + WER

    run = RecipeRun(cfg, work_dir, lexicon, units)     # device="cuda"
    run.build_lang(); labels = run.prep_labels(data)
    feats = run.compute_features(data)
    run.train(tr_feats, tr_labels, cv_feats, cv_labels)
    run.build_graph(arpa_text); stats, hyps = run.decode(test_feats, refs)
    wer_by_acwt = run.score_sweep(test_feats, refs)    # lattices, one decode

The serving functions under it take parameters directly:

    params = init_model(gen, model_cfg)                # or params_from_jax
    lp = posteriors(params, model_cfg, feats, lengths, log_priors)
    hyps = decode(params, model_cfg, graph, feats_by_utt, log_priors,
                  BeamSearchConfig(beam=16.0, max_active=512))

Everything runs on `device` ("cuda" unless the caller asks for "cpu"):
the fbank front end in torch ops, the BiLSTM stack through the fused LSTM
kernel, the search through the recombination kernel.  With
`BeamSearchConfig(blank_skip=0.98)`, as every recipe decodes,
blank-dominated runs of the prior-divided posteriors are merged first
(decoder/frame_skip.py) and the search runs on the compacted frames.
Streaming is models/streaming.py; greedy decoding decoder/greedy.py.
The lattice stages (`decode_lattices`, `score_sweep`) search on the
device and build, prune and determinize the lattices on the host
(decoder/{lattice,clat}).  `RecipeRun(mesh=...)` trains on the mesh
(parallel/, training/trainer.Trainer; on a `model` axis each rank holds
its blocks of the parameters); every rank runs the recipe in the same
work_dir, priors, model.pkl and the decode read the whole parameters
(`Trainer.full_params`), and the files it writes are renamed into
place.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from eesen_tpu_torch.decoder.arpa import arpa_to_fst
from eesen_tpu_torch.decoder.beam import (
    BeamOutputs, BeamSearchConfig, DeviceGraph, make_beam_decoder, traceback,
)
from eesen_tpu_torch.decoder.clat import (
    CompactLattice, determinize_lattice_pruned,
)
from eesen_tpu_torch.decoder.ctc_graph import (
    Lang, build_full_compiled, compile_lang,
)
from eesen_tpu_torch.decoder.frame_skip import compact_blank_frames
from eesen_tpu_torch.decoder.graph_compile import CompiledGraph
from eesen_tpu_torch.decoder.lattice import lattice_from_beam
from eesen_tpu_torch.decoder.score import WerStats, compute_wer
from eesen_tpu_torch.frontend.features import fbank, num_frames
from eesen_tpu_torch.frontend.pipeline import (
    FeaturePipeline, speaker_cmvn_stats,
)
from eesen_tpu_torch.io.datadir import DataDir
from eesen_tpu_torch.io.wave import read_wav
from eesen_tpu_torch.models.model import (
    AcousticModelConfig, apply_model, as_tensor, check_device,
)
from eesen_tpu_torch.models.priors import (
    ClassPriorOptions, compute_log_priors, counts_from_labels,
    subtract_priors,
)
from eesen_tpu_torch.recipes.augment import (
    LIBRISPEECH_ROTATION, base_tag, librispeech_tags, rotation_tag,
)
from eesen_tpu_torch.recipes.config import RecipeConfig
from eesen_tpu_torch.recipes.labels import lexicon_numbers, prep_ctc_trans
from eesen_tpu_torch.training.batching import Utterance, make_batches
from eesen_tpu_torch.training.optim import tree_leaves, tree_unflatten
from eesen_tpu_torch.training.trainer import Trainer, TrainerConfig
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


def _replace_into(path: str, write) -> None:
    """write(f) into a private file renamed onto `path`, so that ranks of a
    mesh sharing a work_dir never read a half-written file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


# utterances per batched fbank call (the JAX package's batch)
FBANK_BATCH = 64


class RecipeRun:
    """One corpus run under `work_dir`: each stage is a method, so partial
    runs and resumes are natural.  Everything runs on `device`; a `mesh`
    (parallel.make_mesh) reaches the Trainer in `train`, and nothing else,
    as in the JAX package (pass device=mesh.device with it); what is
    written and decoded after it is the whole parameters on every
    rank."""

    def __init__(
        self,
        cfg: RecipeConfig,
        work_dir: str,
        lexicon: List[Tuple[str, Tuple[str, ...]]],
        units: List[str],
        mesh=None,
        device="cuda",
    ):
        self.mesh = mesh
        self.device = check_device(device)
        self.cfg = cfg
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.lexicon = lexicon
        self.units = units
        self.lang: Optional[Lang] = None
        self.trainer: Optional[Trainer] = None
        self.graph: Optional[CompiledGraph] = None
        self.log_priors: Optional[np.ndarray] = None
        self.params = None            # decode-ready model parameters
        self.model_cfg = None
        # score_sweep's blank-skip verdicts by (sorted keys, blank_skip)
        self._guard_cache: Dict[Tuple, Tuple[bool, Dict]] = {}

    # ---- stage 1: lang + labels ----
    def build_lang(self) -> Lang:
        path = os.path.join(self.work_dir, "lang.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                self.lang = pickle.load(f)
        else:
            self.lang = compile_lang(
                self.lexicon, self.units, dict_type=self.cfg.dict_type
            )
            _replace_into(path, lambda f: pickle.dump(self.lang, f))
        return self.lang

    def prep_labels(
        self, data: DataDir, unk: str = "<UNK>"
    ) -> Dict[str, np.ndarray]:
        assert self.lang is not None
        lex_num = lexicon_numbers(self.lexicon, self.lang.tokens)
        space = "<SPACE>" if self.cfg.dict_type == "char" else ""
        return prep_ctc_trans(lex_num, data.text, unk, space)

    # ---- stage 2: features ----
    def compute_features(
        self, data: DataDir, dither_seed: Optional[int] = 0
    ) -> Dict[str, np.ndarray]:
        """wav.scp -> pipeline features, with per-speaker CMVN."""
        raw = self._raw_fbank(data, dither_seed)
        cmvn = speaker_cmvn_stats(raw, data.utt2spk)
        pipe = FeaturePipeline(self.cfg.pipeline, cmvn, data.utt2spk)
        return {k: pipe(k, v) for k, v in raw.items()}

    def compute_augmented_features(
        self,
        data: DataDir,
        tags=None,
        dither_seed: Optional[int] = 0,
    ) -> Dict[str, Dict[str, np.ndarray]]:
        """Per-tag pipeline features for the multi-view augmentation flow
        (reference: make_fbank_mult.sh over fbconf-{8,10,11} x
        --vtln-warp {0.8,1.0,1.2}).  CMVN stats come from the canonical
        10_1.0 view only and are applied to every view
        (compute_cmvn_stats_mult.sh --tag 10_1.0).  Returns
        {tag_name: {utt: feats}}."""
        tags = tags or librispeech_tags()
        base = base_tag(tags)
        raw_by_tag = {
            t.name: self._raw_fbank(
                data, dither_seed,
                frame_shift_ms=t.frame_shift_ms, vtln_warp=t.vtln_warp,
            )
            for t in tags
        }
        cmvn = speaker_cmvn_stats(raw_by_tag[base.name], data.utt2spk)
        pipe = FeaturePipeline(self.cfg.pipeline, cmvn, data.utt2spk)
        return {
            name: {k: pipe(k, v) for k, v in raw.items()}
            for name, raw in raw_by_tag.items()
        }

    def _raw_fbank(
        self,
        data: DataDir,
        dither_seed: Optional[int] = 0,
        frame_shift_ms: Optional[float] = None,
        vtln_warp: float = 1.0,
    ) -> Dict[str, np.ndarray]:
        """Log-mel features of every utterance: the waves are zero-padded
        to one power-of-two length and go through the batched `fbank` on
        the device, FBANK_BATCH at a time.  The dither draws from one
        torch.Generator on the device seeded with `dither_seed` (None: no
        dither)."""
        raw: Dict[str, np.ndarray] = {}
        opts = self.cfg.fbank
        if frame_shift_ms is not None:
            opts = dataclasses.replace(
                opts, frame_opts=dataclasses.replace(
                    opts.frame_opts, frame_shift_ms=frame_shift_ms,
                ),
            )
        gen = None
        if dither_seed is not None and opts.frame_opts.dither != 0.0:
            gen = torch.Generator(device=self.device).manual_seed(dither_seed)
        waves = {}
        for k, src in data.wav_scp.items():
            if isinstance(src, np.ndarray):   # in-memory corpora
                waves[k] = src
            else:
                w, sr = read_wav(src)
                waves[k] = w[0]
        if not waves:
            return {}
        max_n = max(len(w) for w in waves.values())
        bucket = 1 << max(int(np.ceil(np.log2(max(max_n, 1024)))), 10)
        keys = sorted(waves)
        for i in range(0, len(keys), FBANK_BATCH):
            chunk = keys[i : i + FBANK_BATCH]
            wp = np.zeros((len(chunk), bucket), np.float32)
            for j, k in enumerate(chunk):
                wp[j, : len(waves[k])] = waves[k]
            out = fbank(
                torch.from_numpy(wp).to(self.device), opts,
                vtln_warp=vtln_warp, generator=gen,
            ).cpu().numpy()
            for j, k in enumerate(chunk):
                nf = num_frames(len(waves[k]), opts.frame_opts)
                raw[k] = out[j, :nf]
        return raw

    # ---- stage 3: training ----
    def train(
        self,
        train_feats: Dict[str, np.ndarray],
        train_labels: Dict[str, np.ndarray],
        cv_feats: Dict[str, np.ndarray],
        cv_labels: Dict[str, np.ndarray],
        epochs_batches_repeat: int = 1,
        tagged_feats: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
        tag_order: Optional[List[str]] = None,
    ) -> Dict:
        """Trainer.fit over the newbob schedule on `device`, then the
        class priors from the training labels; writes model.pkl.

        With tagged_feats (from compute_augmented_features), each
        newbob epoch trains on ONE augmented feature view, rotating
        through tag_order (default: the reference's LibriSpeech list) —
        steps/train_ctc_parallel_mult.sh:205; train_feats then serves as
        the canonical view for the final epochs and CV stays on the
        canonical features."""
        assert self.lang is not None
        num_targets = len(self.units) + 1   # blank + units
        model_cfg = dataclasses.replace(
            self.cfg.model, num_targets=num_targets
        )
        tcfg = TrainerConfig(
            model=model_cfg,
            optimizer=self.cfg.optimizer,
            newbob=self.cfg.newbob,
            checkpoint_dir=os.path.join(self.work_dir, "ckpt"),
        )
        self.trainer = Trainer(tcfg, device=self.device, mesh=self.mesh)

        def mk(feats, labels):
            return [
                Utterance(k, feats[k], labels[k])
                for k in sorted(feats)
                if k in labels and len(labels[k]) > 0
            ]

        tr_utts, cv_utts = mk(train_feats, train_labels), mk(cv_feats, cv_labels)

        if tagged_feats:
            order = tag_order or [
                t for t in LIBRISPEECH_ROTATION if t in tagged_feats
            ]
            utts_by_tag = {
                tag: mk(fe, train_labels) for tag, fe in tagged_feats.items()
            }

            def train_iter(epoch):
                tag = rotation_tag(order, epoch)
                log.info("epoch %d: augmentation tag %s", epoch, tag)
                for _ in range(epochs_batches_repeat):
                    yield from make_batches(utts_by_tag[tag], self.cfg.batch)
        else:
            def train_iter():
                for _ in range(epochs_batches_repeat):
                    yield from make_batches(tr_utts, self.cfg.batch)

        def cv_iter():
            yield from make_batches(cv_utts, self.cfg.batch)

        history = self.trainer.fit(train_iter, cv_iter)
        # priors from the training labels (train_ctc_parallel.sh:119-120)
        counts = counts_from_labels(
            [train_labels[u.key] for u in tr_utts], num_targets
        )
        self.log_priors = compute_log_priors(counts, ClassPriorOptions())
        self.params = self.trainer.full_params()
        self.model_cfg = model_cfg
        params = self.params
        saved = {"params": tree_unflatten(
                     params, [p.cpu() for p in tree_leaves(params)]),
                 "config": model_cfg, "log_priors": self.log_priors}
        _replace_into(os.path.join(self.work_dir, "model.pkl"),
                      lambda f: torch.save(saved, f))
        return history

    def load_model(self, path: Optional[str] = None) -> None:
        """Load decode-ready parameters (torch tensors, placed on `device`)
        from a saved model.pkl — decoding needs no live Trainer (the
        reference's net-output-extract reads any nnet file:
        netbin/net-output-extract.cc:73).  The file is this class's own
        (`train` writes it): torch.load unpickles the config with it."""
        path = path or os.path.join(self.work_dir, "model.pkl")
        d = torch.load(path, map_location=self.device, weights_only=False)
        self.params = d["params"]
        self.model_cfg = d["config"]
        self.log_priors = d.get("log_priors")

    # ---- stage 4: graph + decode + score ----
    def build_graph(self, arpa_path_or_text: str) -> CompiledGraph:
        assert self.lang is not None
        path = os.path.join(self.work_dir, "tlg.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                self.graph = pickle.load(f)
            return self.graph
        g = arpa_to_fst(arpa_path_or_text, self.lang.words)
        self.graph = build_full_compiled(
            self.lang.t_fst, self.lang.l_fst, g, build_closure=True
        )
        _replace_into(path, lambda f: pickle.dump(self.graph, f))
        return self.graph

    def _decode_params(self):
        if self.params is None and self.trainer is not None:
            self.params = self.trainer.full_params()
            self.model_cfg = self.trainer.cfg.model
        if self.params is None:
            self.load_model()
        assert self.params is not None and self.model_cfg is not None
        return self.params, self.model_cfg

    def _posteriors(
        self,
        feats: Dict[str, np.ndarray],
        chunk: List[str],
        time_bucket: int = 128,
        batch_pad: int = 0,
    ) -> Tuple[torch.Tensor, np.ndarray]:
        """Model posteriors for a chunk: T rounded up to `time_bucket`, B
        padded to `batch_pad` (zero rows, length 0), as the JAX package
        shape-buckets its compiled forward."""
        params, model_cfg = self._decode_params()
        arr, lens = _pad_chunk(feats, chunk, time_bucket, batch_pad)
        return posteriors(params, model_cfg, arr, lens, self.log_priors,
                          self.device), lens

    def _run_search(self, feats, keys, cfg, batch_size):
        """Batched beam search over `keys`, longest first; yields (chunk,
        lp, lens, out) from `run_search` (with cfg.blank_skip > 0 the
        compacted lp and lens the search saw; a chunk that overflowed its
        word buffer decoded again with doubled max_olabels)."""
        params, model_cfg = self._decode_params()
        yield from run_search(
            params, model_cfg, self.graph, {k: feats[k] for k in keys},
            self.log_priors, cfg, batch_size, device=self.device,
        )

    def decode(
        self,
        feats: Dict[str, np.ndarray],
        refs: Dict[str, List[str]],
        acoustic_scale: Optional[float] = None,
        batch_size: int = 8,
    ) -> Tuple[WerStats, Dict[str, List[str]]]:
        """Best-path decode -> WER.  Works from a live Trainer OR from the
        saved model.pkl (load_model)."""
        assert self.graph is not None and self.lang is not None
        cfg = self.cfg.decode
        if acoustic_scale is not None:
            cfg = dataclasses.replace(cfg, acoustic_scale=acoustic_scale)
        words = self.lang.words
        hyps: Dict[str, List[str]] = {}
        for chunk, lp, lens, out in self._run_search(
            feats, sorted(feats), cfg, batch_size
        ):
            # zip: the batch may carry padded zero-length rows past chunk
            for k, (wids, cost) in zip(
                chunk, traceback(out, lens, self.graph.final_weight)
            ):
                hyps[k] = [words.sym(w) for w in wids]
        stats = compute_wer(refs, hyps)
        return stats, hyps

    def check_blank_skip_parity(
        self,
        feats: Dict[str, np.ndarray],
        sample: Optional[int] = None,
        batch_size: int = 8,
        seed: int = 0,
    ) -> Tuple[bool, Dict[str, object]]:
        """Decode a random sample of utterances both WITH and WITHOUT
        blank-run merging and compare best-path word sequences.

        Blank-run merging is exact only when each merged blank run
        carries at most one label transition (frame_skip.py docstring);
        this guard validates that premise on the actual decode content
        before a scoring pass trusts the skipping results.  Returns
        (ok, {"checked": keys, "mismatched": keys})."""
        cfg = self.cfg.decode
        if cfg.blank_skip <= 0.0 or not feats:
            return True, {"checked": [], "mismatched": []}
        keys = sorted(feats)
        n = min(sample or self.cfg.blank_skip_guard or 4, len(keys))
        rng = np.random.default_rng(seed)
        pick = sorted(
            keys[i] for i in rng.choice(len(keys), size=n, replace=False)
        )
        sub = {k: feats[k] for k in pick}

        def best_words(c):
            hyps = {}
            for chunk, lp, lens, out in self._run_search(
                sub, pick, c, batch_size
            ):
                for k, (wids, _) in zip(
                    chunk, traceback(out, lens, self.graph.final_weight)
                ):
                    hyps[k] = wids
            return hyps

        skip = best_words(cfg)
        full = best_words(dataclasses.replace(cfg, blank_skip=0.0))
        mismatched = sorted(k for k in pick if skip.get(k) != full.get(k))
        return not mismatched, {"checked": pick, "mismatched": mismatched}

    def decode_lattices(
        self,
        feats: Dict[str, np.ndarray],
        batch_size: int = 8,
        lattice_beam: Optional[float] = None,
        keep_tokens: int = 64,
        decode_cfg: Optional[BeamSearchConfig] = None,
    ) -> Dict[str, CompactLattice]:
        """Decode ONCE and return determinized CompactLattices with
        UNSCALED acoustic costs, ready for acwt sweeps/rescoring without
        re-decoding (reference: DecodeUtteranceLatticeFaster decodes,
        determinizes in the pair semiring, unscales by 1/acwt, writes —
        decoder-wrappers.cc:87-107; scoring then sweeps by lattice-scale,
        local/score.sh:44-55).

        The search runs on `device`; each chunk's outputs and
        log-posteriors come to the host once, and the lattice work
        (reconstruction, pruning, determinization) is host numpy.

        With cfg.blank_skip > 0 the lattices span the COMPACTED frame
        axis (each blank run merged into one run-summed frame); path
        costs, word sequences and acwt sweeps match the full decode
        (frame_skip.py docstring), but per-frame CTM timings refer to
        kept frames only."""
        assert self.graph is not None
        base = decode_cfg if decode_cfg is not None else self.cfg.decode
        lbeam = (
            lattice_beam if lattice_beam is not None
            else (base.lattice_beam or 8.0)
        )
        cfg = dataclasses.replace(base, lattice_beam=lbeam)
        acwt = cfg.acoustic_scale
        lats: Dict[str, CompactLattice] = {}
        for chunk, lp, lens, out in self._run_search(
            feats, sorted(feats), cfg, batch_size
        ):
            host = out.numpy()
            ll = lp.detach().to("cpu", torch.float32).numpy()
            for j, k in enumerate(chunk):
                raw = lattice_from_beam(
                    host, j, int(lens[j]), self.graph, ll[j],
                    acwt, keep_tokens=keep_tokens,
                )
                # lattice_beam applies in the search-cost domain (the
                # raw lattice's acoustics are scaled by acwt, like the
                # reference's in-decoder costs)
                raw.prune(lbeam)
                clat = determinize_lattice_pruned(raw, lattice_beam=lbeam)
                # store with unscaled acoustics for later sweeps
                lats[k] = clat.scaled(1.0 / acwt if acwt else 1.0)
        return lats

    def score_sweep(
        self,
        feats,
        refs,
        acwts: Optional[Tuple[float, ...]] = None,
        word_ins_penalty: float = 0.0,
        batch_size: int = 8,
    ) -> Dict[float, WerStats]:
        """Per-acwt WER from ONE decode pass: lattices are generated once
        and rescaled per acwt (local/score.sh:44-55 lattice-scale |
        lattice-best-path | compute-wer).

        With blank-skip on, the blank-skip guard runs first and a failed
        verdict decodes this pass without skipping.  The verdict is
        cached per (sorted keys, blank_skip), as the JAX package caches
        it: the key leaves out the model, so after more training or new
        parameters a second sweep over the same keys reuses the old
        verdict (ROADMAP.md §3)."""
        assert self.lang is not None
        words = self.lang.words
        dcfg = self.cfg.decode
        if dcfg.blank_skip > 0.0 and self.cfg.blank_skip_guard > 0:
            guard_key = (tuple(sorted(feats)), dcfg.blank_skip)
            cached = self._guard_cache.get(guard_key)
            if cached is not None:
                ok, info = cached
            else:
                ok, info = self.check_blank_skip_parity(
                    feats, batch_size=batch_size
                )
                self._guard_cache[guard_key] = (ok, info)
            if ok:
                log.info(
                    "blank-skip parity guard: %d/%d sampled utterances "
                    "word-identical to the full decode",
                    len(info["checked"]), len(info["checked"]),
                )
            else:
                log.warning(
                    "blank-skip parity guard FAILED on %s — falling back "
                    "to the full (non-skipping) decode for this pass",
                    info["mismatched"],
                )
                dcfg = dataclasses.replace(dcfg, blank_skip=0.0)
        lats = self.decode_lattices(
            feats, batch_size=batch_size, decode_cfg=dcfg
        )
        out: Dict[float, WerStats] = {}
        for acwt in acwts or self.cfg.acwt_sweep:
            hyps: Dict[str, List[str]] = {}
            for k, clat in lats.items():
                sc = clat.scaled(acwt)
                if word_ins_penalty:
                    sc.add_penalty(word_ins_penalty)
                _, wids, _ = sc.best_path()
                hyps[k] = [words.sym(w) for w in wids]
            stats = compute_wer(refs, hyps)
            log.info("acwt %.2f: %s", acwt, stats.report())
            out[acwt] = stats
        return out
