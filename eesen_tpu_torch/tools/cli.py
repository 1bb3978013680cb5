"""Command-line tools: the archive->archive surface of the reference bins
(counterpart of eesen_tpu/tools/cli.py).

One `python -m eesen_tpu_torch.tools.cli [--device DEV] <command>`
multiplexer covering the single-purpose binaries the recipes drive
(reference: src/featbin/, src/netbin/net-output-extract.cc,
src/decoderbin/compute-wer.cc, src/decoderbin/arpa2fst.cc, the graph
build of utils/ctc_compile_dict_token.sh + local/*_decode_graph.sh).
All commands speak rspecifiers ("ark:...", "scp:...", "-") like the
originals, with the JAX package's commands, arguments and defaults.

`--device` (default "cuda") is where the commands that compute run:
the front end, the acoustic model (kernel 1), the beam search (kernel 2),
the dense decoder, forced alignment and training (kernels 1, 3, 6, 7).
Without a card they raise unless given `--device cpu`, which runs the
kernels' plain versions.  Every other command is host code and never
touches CUDA.

Model files are the blob `recipes/run.RecipeRun.train` writes,
`torch.save({"params", "config"[, "log_priors"]})` with CPU tensors, or
Kaldi `<Nnet>` files (`*.nnet`); graph and lang files are pickles of this
package's objects.  Both are read through an unpickler that refuses the
JAX package's classes (and jax's), so loading a JAX model or graph
pickle never imports it: convert a JAX model with the JAX package's
`net-copy model.pkl x.nnet` and pass x.nnet; rebuild a graph with this
package's `build-tlg`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import types
import zipfile

import numpy as np
import torch

from eesen_tpu_torch.io.kaldi_io import read_rspecifier, read_scp, write_ark
from eesen_tpu_torch.models.model import AcousticModelConfig, check_device
from eesen_tpu_torch.training.optim import tree_leaves, tree_unflatten
from eesen_tpu_torch.utils.logging import get_logger

log = get_logger("tools.cli")


def _wspec(path: str):
    """'ark:file' / 'ark,scp:file,scp' -> (ark_path, scp_path)."""
    if path.startswith("ark,scp:"):
        ark, scp = path[len("ark,scp:"):].split(",")
        return ark, scp
    if path.startswith("ark:"):
        return path[4:], None
    return path, None


# --------------------------------------------------------------------------
# model and graph files
# --------------------------------------------------------------------------

class ForeignPickleError(pickle.UnpicklingError):
    """A pickle that names a class of the JAX package or of jax."""


def _foreign(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("eesen_tpu", "jax", "jaxlib")


class _PortUnpickler(pickle.Unpickler):
    """pickle.Unpickler that refuses, before importing it, any class of
    the JAX package or of jax."""

    def find_class(self, module, name):
        if _foreign(module):
            raise ForeignPickleError(f"{module}.{name}")
        return super().find_class(module, name)


# torch.load's pickle_module: its unpickler subclasses this Unpickler
# (torch also reads the module's __name__)
_PORT_PICKLE = types.SimpleNamespace(
    Unpickler=_PortUnpickler,
    load=lambda f, **kw: _PortUnpickler(f, **kw).load(),
    __name__="eesen_tpu_torch.tools.cli")


def _refusal(path: str, what: str, cls: str) -> ForeignPickleError:
    how = (
        "convert it with the JAX package's `net-copy "
        f"{path} x.nnet` and pass x.nnet"
        if what == "model" else
        "rebuild it with this package's build-lang / build-tlg"
    )
    return ForeignPickleError(
        f"{path}: a {what} file pickled by the JAX package ({cls}); the "
        f"port does not load it: {how}"
    )


def load_pickle(path: str, what: str = "graph"):
    """A pickle of this package's objects (graph, lang); refuses the JAX
    package's."""
    with open(path, "rb") as f:
        try:
            return _PortUnpickler(f).load()
        except ForeignPickleError as e:
            raise _refusal(path, what, str(e)) from None


def _to(params, device):
    return tree_unflatten(params, [p.to(device) for p in tree_leaves(params)])


def load_model_blob(path: str, device="cpu") -> dict:
    """{"params", "config"[, "log_priors"]} from a model file: a `.nnet`
    (read_eesen_nnet), or this package's blob (torch.save, as RecipeRun and
    this CLI write it; a plain pickle of it is read too).  Parameters as
    float32 tensors on `device`."""
    device = check_device(device)
    if path.endswith(".nnet"):
        from eesen_tpu_torch.models.serialize import read_eesen_nnet

        params, cfg = read_eesen_nnet(path, device=device)
        return {"params": params, "config": cfg}
    try:
        if zipfile.is_zipfile(path):
            blob = torch.load(path, map_location=device, weights_only=False,
                              pickle_module=_PORT_PICKLE)
        else:
            with open(path, "rb") as f:
                blob = _PortUnpickler(f).load()
    except ForeignPickleError as e:
        raise _refusal(path, "model", str(e)) from None
    if not isinstance(blob, dict) or not isinstance(
            blob.get("config"), AcousticModelConfig):
        raise ValueError(f"{path}: not a model file of this package")
    return dict(blob, params=_to(blob["params"], device))


def load_model(path: str, device="cpu"):
    blob = load_model_blob(path, device)
    return blob["params"], blob["config"]


def save_model_blob(path: str, blob: dict) -> None:
    """The blob as RecipeRun writes it: torch.save with CPU tensors."""
    torch.save(dict(blob, params=_to(blob["params"], "cpu")), path)


def _symbols(path):
    from eesen_tpu_torch.decoder.ctc_graph import SymbolTable
    return SymbolTable.read(path) if path else None


def _text(words, wids) -> str:
    return (" ".join(words.sym(w) for w in wids) if words
            else " ".join(map(str, wids)))


def _out_file(path):
    return sys.stdout if path == "-" else open(path, "w")


def _close(out_f):
    if out_f is not sys.stdout:
        out_f.close()


def _pad_batch(batch):
    """Log-likelihood matrices padded with -30 to [B, T_max, V], and
    their lengths."""
    t_max = max(x.shape[0] for x in batch)
    v = batch[0].shape[1]
    arr = np.full((len(batch), t_max, v), -30.0, np.float32)
    lens = np.zeros(len(batch), np.int32)
    for i, x in enumerate(batch):
        arr[i, : len(x)] = x
        lens[i] = len(x)
    return arr, lens


# --------------------------------------------------------------------------
# feature commands (reference: src/featbin/)
# --------------------------------------------------------------------------

def _waves(rspec: str):
    """(key, 1-D or [C, N] wave) from a wav scp or an archive."""
    from eesen_tpu_torch.io.wave import read_wav

    wav_scp = read_scp(rspec.split(":", 1)[1]) \
        if rspec.startswith("scp:") else None
    items = wav_scp.items() if wav_scp is not None else read_rspecifier(rspec)
    for key, src in items:
        if isinstance(src, str):
            yield key, read_wav(src)[0]
        else:
            yield key, np.asarray(src).reshape(1, -1)


def cmd_compute_feats(args, kind: str) -> int:
    """Features on --device; no generator is given, so --dither adds no
    noise (the JAX package's CLI passes no dither key either)."""
    from eesen_tpu_torch.frontend.features import (
        FbankOptions, FrameOptions, MelOptions, fbank,
    )
    from eesen_tpu_torch.frontend.mfcc import (
        MfccOptions, SpectrogramOptions, mfcc, spectrogram,
    )
    from eesen_tpu_torch.frontend.plp import PlpOptions, plp

    dev = check_device(args.device)
    frame_opts = FrameOptions(
        samp_freq=args.sample_frequency,
        frame_shift_ms=args.frame_shift,
        frame_length_ms=args.frame_length,
        dither=args.dither,
        preemph_coeff=args.preemphasis_coefficient,
        window_type=args.window_type,
    )
    mel_opts = MelOptions(num_bins=args.num_mel_bins)
    out_ark, out_scp = _wspec(args.feats_wspecifier)

    def gen():
        for key, wave in _waves(args.wav_rspecifier):
            wave = wave[min(args.channel, wave.shape[0] - 1)]
            if kind == "fbank":
                feats = fbank(wave, FbankOptions(
                    frame_opts=frame_opts, mel_opts=mel_opts,
                    use_energy=args.use_energy,
                ), vtln_warp=args.vtln_warp, device=dev)
            elif kind == "mfcc":
                feats = mfcc(wave, MfccOptions(
                    frame_opts=frame_opts, mel_opts=mel_opts,
                    num_ceps=args.num_ceps, use_energy=args.use_energy,
                ), vtln_warp=args.vtln_warp, device=dev)
            elif kind == "plp":
                feats = plp(wave, PlpOptions(
                    frame_opts=frame_opts, mel_opts=mel_opts,
                ), vtln_warp=args.vtln_warp, device=dev)
            else:
                feats = spectrogram(
                    wave, SpectrogramOptions(frame_opts=frame_opts),
                    device=dev,
                )
            yield key, feats.cpu().numpy()

    write_ark(out_ark, gen(), scp_path=out_scp)
    return 0


def cmd_compute_cmvn_stats(args) -> int:
    from eesen_tpu_torch.frontend.pipeline import speaker_cmvn_stats

    utt2spk = {}
    if args.spk2utt:
        spk2utt = read_scp(args.spk2utt.split(":", 1)[1])
        for spk, utts in spk2utt.items():
            for u in utts.split():
                utt2spk[u] = spk
    feats = {k: v for k, v in read_rspecifier(args.feats_rspecifier)}
    stats = speaker_cmvn_stats(feats, utt2spk)
    out_ark, out_scp = _wspec(args.stats_wspecifier)
    write_ark(out_ark, stats.items(), scp_path=out_scp)
    return 0


def cmd_apply_cmvn(args) -> int:
    from eesen_tpu_torch.frontend.features import apply_cmvn

    stats = {k: v for k, v in read_rspecifier(args.stats_rspecifier)}
    utt2spk = {}
    if args.utt2spk:
        utt2spk = read_scp(args.utt2spk.split(":", 1)[1])
    out_ark, out_scp = _wspec(args.feats_wspecifier)

    def gen():
        for key, feats in read_rspecifier(args.feats_rspecifier):
            skey = utt2spk.get(key, key)
            yield key, np.asarray(
                apply_cmvn(feats, stats[skey], args.norm_vars)
            )

    write_ark(out_ark, gen(), scp_path=out_scp)
    return 0


def _simple_transform(args, fn) -> int:
    out_ark, out_scp = _wspec(args.feats_wspecifier)
    write_ark(
        out_ark,
        ((k, np.asarray(fn(v))) for k, v in
         read_rspecifier(args.feats_rspecifier)),
        scp_path=out_scp,
    )
    return 0


def cmd_add_deltas(args) -> int:
    from eesen_tpu_torch.frontend.features import compute_deltas
    return _simple_transform(
        args, lambda f: compute_deltas(f, args.delta_order, args.delta_window)
    )


def cmd_splice_feats(args) -> int:
    from eesen_tpu_torch.frontend.features import splice_frames
    return _simple_transform(
        args, lambda f: splice_frames(f, args.left_context, args.right_context)
    )


def cmd_subsample_feats(args) -> int:
    from eesen_tpu_torch.frontend.features import subsample_frames
    return _simple_transform(
        args, lambda f: subsample_frames(f, args.n, args.offset)
    )


def cmd_copy_feats(args) -> int:
    return _simple_transform(args, lambda f: f)


def cmd_paste_feats(args) -> int:
    """Concatenate feature streams per utterance dimension-wise
    (reference: src/featbin/paste-feats.cc)."""
    streams = [dict(read_rspecifier(r)) for r in args.in_rspecifiers]
    out_ark, out_scp = _wspec(args.feats_wspecifier)

    def gen():
        for key in streams[0]:
            if not all(key in s for s in streams):
                continue
            mats = [np.asarray(s[key]) for s in streams]
            f = min(m.shape[0] for m in mats)
            yield key, np.concatenate([m[:f] for m in mats], axis=1)

    write_ark(out_ark, gen(), scp_path=out_scp)
    return 0


def cmd_extract_segments(args) -> int:
    """Cut waveforms by a segments file (reference:
    src/featbin/extract-segments.cc): each line 'utt rec start end'."""
    from eesen_tpu_torch.io.wave import read_wav

    segments = []
    with open(args.segments) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                segments.append(
                    (parts[0], parts[1], float(parts[2]), float(parts[3]))
                )
    wav_scp = read_scp(args.wav_rspecifier.split(":", 1)[1])
    out_ark, out_scp = _wspec(args.wav_wspecifier)

    def gen():
        cache = {}
        for utt, rec, start, end in segments:
            if rec not in wav_scp:
                continue
            if rec not in cache:
                cache.clear()
                cache[rec] = read_wav(wav_scp[rec])
            wave, sr = cache[rec]
            s, e = int(start * sr), int(end * sr)
            if e <= s or s >= wave.shape[1]:
                continue
            yield utt, wave[:1, s:e]

    write_ark(out_ark, gen(), scp_path=out_scp)
    return 0


def cmd_compute_pitch(args) -> int:
    """(= featbin/compute-kaldi-pitch-feats + process-kaldi-pitch-feats)"""
    from eesen_tpu_torch.frontend.pitch import (
        PitchOptions, ProcessPitchOptions, kaldi_pitch, process_pitch,
    )

    dev = check_device(args.device)
    opts = PitchOptions(
        samp_freq=args.sample_frequency,
        min_f0=args.min_f0, max_f0=args.max_f0,
    )
    popts = ProcessPitchOptions()
    out_ark, out_scp = _wspec(args.feats_wspecifier)

    def gen():
        for key, wave in _waves(args.wav_rspecifier):
            raw = kaldi_pitch(wave[0], opts, device=dev)
            yield key, process_pitch(raw, popts).cpu().numpy()

    write_ark(out_ark, gen(), scp_path=out_scp)
    return 0


def cmd_feat_to_dim(args) -> int:
    for _, v in read_rspecifier(args.feats_rspecifier):
        print(v.shape[-1])
        return 0
    return 1


def cmd_feat_to_len(args) -> int:
    for k, v in read_rspecifier(args.feats_rspecifier):
        print(k, v.shape[0])
    return 0


# --------------------------------------------------------------------------
# graph / LM commands
# --------------------------------------------------------------------------

def cmd_build_lang(args) -> int:
    """tokens.txt/words.txt/T/L from lexicon + units
    (= utils/ctc_compile_dict_token.sh)."""
    from eesen_tpu_torch.decoder.ctc_graph import compile_lang

    lexicon = []
    with open(args.lexicon) as f:
        for line in f:
            parts = line.split()
            if parts:
                lexicon.append((parts[0], tuple(parts[1:])))
    with open(args.units) as f:
        units = [l.split()[0] for l in f if l.strip()]
    lang = compile_lang(lexicon, units, dict_type=args.dict_type,
                        space_char=args.space_char)
    os.makedirs(args.out_dir, exist_ok=True)
    lang.tokens.write(os.path.join(args.out_dir, "tokens.txt"))
    lang.words.write(os.path.join(args.out_dir, "words.txt"))
    with open(os.path.join(args.out_dir, "T.fst.txt"), "w") as f:
        f.write(lang.t_fst.to_text())
    with open(os.path.join(args.out_dir, "L.fst.txt"), "w") as f:
        f.write(lang.l_fst.to_text())
    with open(os.path.join(args.out_dir, "lang.pkl"), "wb") as f:
        pickle.dump(lang, f)
    log.info("built lang dir %s (%d tokens, %d words)", args.out_dir,
             len(lang.tokens), len(lang.words))
    return 0


def cmd_prep_corpus(args) -> int:
    """Raw corpus tree -> Kaldi data dir(s)
    (= the reference's local/*_data_prep.sh shell entry points)."""
    from eesen_tpu_torch.recipes import data_prep as dp

    c = args.corpus
    if c == "librispeech":
        out = {"data": dp.librispeech_prep(args.src[0], args.dst)}
    elif c == "wsj":
        out = dp.wsj_prep(args.src, args.dst)
    elif c == "tedlium":
        out = dp.tedlium_prep(args.src[0], args.dst)
    elif c == "swbd1":
        out = {"train": dp.swbd1_prep(args.src[0], args.dst,
                                      trans_dir=args.trans_dir)}
    elif c == "hkust":
        if len(args.src) != 2:
            raise SystemExit("hkust needs SRC = <audio_dir> <text_dir>")
        out = dp.hkust_prep(args.src[0], args.src[1], args.dst)
    else:  # pragma: no cover - argparse choices guard this
        raise SystemExit(f"unknown corpus {c}")
    for name, dd in out.items():
        log.info(
            "prepared %s: %d utts, %d speakers", name, len(dd.wav_scp),
            len(set(dd.utt2spk.values())),
        )
    return 0


def cmd_build_tlg(args) -> int:
    """TLG from a lang dir + ARPA LM (= local/*_decode_graph.sh)."""
    from eesen_tpu_torch.decoder.arpa import arpa_to_fst
    from eesen_tpu_torch.decoder.ctc_graph import build_lg, build_tlg_compiled

    lang = load_pickle(os.path.join(args.lang_dir, "lang.pkl"), "lang")
    g = arpa_to_fst(args.arpa, lang.words)
    log.info("G: %d states %d arcs", g.num_states, g.num_arcs)
    lg = build_lg(lang.l_fst, g)
    log.info("LG det+min: %d states %d arcs", lg.num_states, lg.num_arcs)
    compiled = build_tlg_compiled(
        lang.t_fst, lg, max_degree=args.max_degree, build_closure=True
    )
    log.info("TLG compiled: %d states", compiled.num_states)
    with open(args.out, "wb") as f:
        pickle.dump(compiled, f)
    log.info("wrote compiled graph %s", args.out)
    return 0


# --------------------------------------------------------------------------
# net / decode commands
# --------------------------------------------------------------------------

def _log_posteriors(params, cfg, feats, dev) -> torch.Tensor:
    """One utterance [T, D] through the model: [T, V] log-softmax on
    `dev` (B=1, unpadded T, as the JAX package's CLI runs it)."""
    from eesen_tpu_torch.models.model import apply_model, as_tensor

    x = as_tensor(feats, torch.float32)[None].to(dev)
    lengths = torch.tensor([feats.shape[0]], device=dev)
    return torch.log_softmax(apply_model(params, x, lengths, cfg), dim=-1)[0]


def cmd_net_output_extract(args) -> int:
    """Posteriors (log, prior-subtracted) from a trained model
    (= netbin/net-output-extract.cc)."""
    from eesen_tpu_torch.models.priors import (
        ClassPriorOptions, compute_log_priors, subtract_priors,
    )

    dev = check_device(args.device)
    params, cfg = load_model(args.model, dev)
    log_priors = None
    if args.class_frame_counts:
        counts = np.loadtxt(args.class_frame_counts)
        log_priors = compute_log_priors(
            counts, ClassPriorOptions(
                prior_scale=args.prior_scale, blank_scale=args.blank_scale,
            )
        )
    out_ark, out_scp = _wspec(args.out_wspecifier)

    def gen():
        for key, feats in read_rspecifier(args.feats_rspecifier):
            lp = _log_posteriors(params, cfg, feats, dev)
            if log_priors is not None:
                lp = subtract_priors(lp, log_priors, args.prior_scale)
            yield key, lp.cpu().numpy()

    write_ark(out_ark, gen(), scp_path=out_scp)
    return 0


def cmd_latgen(args) -> int:
    """Batched beam decode on --device -> text hypotheses
    (= decoderbin/latgen-faster.cc best-path output)."""
    from eesen_tpu_torch.decoder.beam import (
        BeamSearchConfig, DeviceGraph, StreamingBeamDecoder,
        make_beam_decoder, traceback,
    )
    from eesen_tpu_torch.decoder.frame_skip import compact_blank_frames

    dev = check_device(args.device)
    graph = load_pickle(args.graph)
    words = _symbols(args.words)
    cfg = BeamSearchConfig(
        beam=args.beam, max_active=args.max_active,
        acoustic_scale=args.acoustic_scale,
    )
    if args.blank_skip > 0.0:
        cfg = dataclasses.replace(cfg, blank_skip=args.blank_skip)
    want_lats = args.lattice_ark
    if want_lats:
        cfg = dataclasses.replace(cfg, lattice_beam=args.lattice_beam)
    if args.streaming:
        # chunked online decode with carried search state (identical
        # results to the offline one-shot decode)
        if want_lats:
            raise ValueError("--streaming emits text only")
        sdec = StreamingBeamDecoder(graph, cfg, device=dev)
    else:
        decoder = make_beam_decoder(graph, cfg)
        dg = DeviceGraph.put(graph, device=dev)

    batch, keys, lats = [], [], []

    def flush(out_f):
        if not batch:
            return
        arr, lens = _pad_batch(batch)
        if args.streaming:
            ck = args.chunk_frames
            t_max = arr.shape[1]
            t_pad = -(-t_max // ck) * ck
            if t_pad > t_max:
                arr = np.pad(arr, ((0, 0), (0, t_pad - t_max), (0, 0)),
                             constant_values=-30.0)
            st = sdec.start(len(batch))
            for t0 in range(0, t_pad, ck):
                active = (t0 + np.arange(ck))[None, :] < lens[:, None]
                st = sdec.accept(st, arr[:, t0:t0 + ck], active)
            results = sdec.finish(st)
        else:
            lp = torch.from_numpy(arr).to(dev)
            if args.blank_skip > 0.0:
                cf = compact_blank_frames(lp, lens, args.blank_skip)
                lp = cf.loglikes
                lens = cf.lengths.cpu().numpy()
                if want_lats:
                    arr = lp.cpu().numpy()
            out = decoder(lp, lens, dg)
            results = traceback(out, lens, graph.final_weight)
        for i, (wids, _) in enumerate(results):
            out_f.write(f"{keys[i]} {_text(words, wids)}\n")
        if want_lats:
            from eesen_tpu_torch.decoder.clat import (
                determinize_lattice_pruned,
            )
            from eesen_tpu_torch.decoder.lattice import lattice_from_beam

            host = out.numpy()                 # one copy a batch
            for i, key in enumerate(keys):
                raw = lattice_from_beam(
                    host, i, int(lens[i]), graph, arr[i],
                    args.acoustic_scale, keep_tokens=64,
                )
                raw.prune(args.lattice_beam)
                clat = determinize_lattice_pruned(
                    raw, lattice_beam=args.lattice_beam
                )
                # archives hold unscaled acoustics (decoder-wrappers.cc
                # :100-107 ScaleLattice by 1/acwt before writing)
                lats.append((
                    key,
                    clat.scaled(
                        1.0 / args.acoustic_scale
                        if args.acoustic_scale else 1.0
                    ),
                ))
        batch.clear()
        keys.clear()

    out_f = _out_file(args.out)
    try:
        for key, ll in read_rspecifier(args.loglikes_rspecifier):
            batch.append(np.asarray(ll, np.float32))
            keys.append(key)
            if len(batch) >= args.batch_size:
                flush(out_f)
        flush(out_f)
    finally:
        _close(out_f)
    if want_lats:
        from eesen_tpu_torch.decoder.lattice_io import write_lattice_ark
        write_lattice_ark(args.lattice_ark, iter(lats), binary=args.binary)
    return 0


def cmd_decode_faster(args) -> int:
    """Exact (beam-free) best-path decode via the dense trellis decoder
    on --device (= decoderbin/decode-faster.cc with an infinite beam; see
    decoder/dense.py)."""
    from eesen_tpu_torch.decoder.dense import (
        DenseDeviceGraph, build_dense_graph, decode_dense,
    )

    dev = check_device(args.device)
    graph = load_pickle(args.graph)
    if not graph.has_closure:
        raise ValueError(
            "decode-faster needs a graph compiled with build_closure "
            "(build-tlg default)"
        )
    words = _symbols(args.words)
    dg = build_dense_graph(graph, in_degree=args.in_degree)
    dev_graph = DenseDeviceGraph.put(dg, device=dev)

    batch, keys = [], []

    def flush(out_f):
        if not batch:
            return
        arr, lens = _pad_batch(batch)
        for i, (wids, _) in enumerate(
            decode_dense(arr, lens, dg, dev_graph, args.acoustic_scale)
        ):
            out_f.write(f"{keys[i]} {_text(words, wids)}\n")
        batch.clear()
        keys.clear()

    out_f = _out_file(args.out)
    try:
        for key, ll in read_rspecifier(args.loglikes_rspecifier):
            batch.append(np.asarray(ll, np.float32))
            keys.append(key)
            if len(batch) >= args.batch_size:
                flush(out_f)
        flush(out_f)
    finally:
        _close(out_f)
    return 0


def cmd_model_info(args) -> int:
    """(= netbin/net-model-info.cc)"""
    from eesen_tpu_torch.models.model import model_num_params

    params, cfg = load_model(args.model)
    print(f"input-dim {cfg.input_dim}")
    print(f"cell-dim {cfg.cell_dim}")
    print(f"num-layers {cfg.num_layers}")
    print(f"num-targets {cfg.num_targets}")
    print(f"num-params {model_num_params(params)}")
    return 0


def cmd_net_average(args) -> int:
    """Average model parameters (= netbin/net-average.cc)."""
    blobs = [load_model_blob(path) for path in args.models]
    n = len(blobs)
    leaves = [tree_leaves(b["params"]) for b in blobs]
    params = tree_unflatten(blobs[0]["params"], [
        sum(xs) / n for xs in zip(*leaves)])
    save_model_blob(args.out, dict(blobs[0], params=params))
    return 0


def _write_model(path: str, params, cfg, parallel: bool) -> None:
    if path.endswith(".nnet"):
        from eesen_tpu_torch.models.serialize import write_eesen_nnet
        write_eesen_nnet(path, params, cfg, parallel=parallel)
    else:
        save_model_blob(path, {"params": params, "config": cfg})


def cmd_net_change_model(args) -> int:
    """Rewrite a saved model's dropout hyperparameters without touching
    weights (= netbin/net-change-model.cc: mid-training schedule changes
    for the dropout-variant experiments).  Works on this package's model
    blobs and on reference .nnet files (read -> change -> write)."""
    params, cfg = load_model(args.src)
    mode = cfg.recurrent_dropout_mode
    if args.rnndrop:
        mode = "rnndrop"
    if args.nmldrop:
        mode = "no_mem_loss"
    cfg = dataclasses.replace(
        cfg,
        forward_dropout=(
            args.forwarddrop if args.forwarddrop is not None
            else cfg.forward_dropout),
        recurrent_dropout=(
            args.recurrentdrop if args.recurrentdrop is not None
            else cfg.recurrent_dropout),
        forward_step_dropout=(
            args.forwardstep if args.forwardstep is not None
            else cfg.forward_step_dropout),
        recurrent_step_dropout=(
            args.recurrentstep if args.recurrentstep is not None
            else cfg.recurrent_step_dropout),
        recurrent_dropout_mode=mode,
        twiddle=(args.twiddleforward if args.twiddleforward is not None
                 else cfg.twiddle),
    )
    _write_model(args.dst, params, cfg, args.parallel)
    print(f"net-change-model: wrote {args.dst} "
          f"(fw={cfg.forward_dropout} rec={cfg.recurrent_dropout} "
          f"mode={cfg.recurrent_dropout_mode} twiddle={cfg.twiddle})")
    return 0


def cmd_net_copy(args) -> int:
    """Convert between this package's model blob and the reference .nnet
    formats (= netbin/net-copy.cc + format-to-nonparallel.cc)."""
    blob = load_model_blob(args.src)
    if args.dst.endswith(".nnet"):
        _write_model(args.dst, blob["params"], blob["config"], args.parallel)
    else:
        save_model_blob(args.dst, blob)
    return 0


def cmd_align(args) -> int:
    """Forced alignment on --device (= steps/align_ctc_single_utt.sh)."""
    from eesen_tpu_torch.ops.align import align_to_segments, ctc_align

    dev = check_device(args.device)
    params, cfg = load_model(args.model, dev)
    labels = {
        k: np.asarray(v, np.int32)
        for k, v in read_rspecifier(args.labels_rspecifier)
    }
    out_f = _out_file(args.out)
    try:
        for key, feats in read_rspecifier(args.feats_rspecifier):
            if key not in labels:
                continue
            lp = _log_posteriors(params, cfg, feats, dev)[None]
            aligns = ctc_align(lp, [feats.shape[0]], labels[key][None, :],
                               [len(labels[key])])
            segs = align_to_segments(aligns[0])
            seg_str = " ".join(f"{l}:{s}:{e}" for l, s, e in segs)
            out_f.write(f"{key} {seg_str}\n")
    finally:
        _close(out_f)
    return 0


def cmd_compute_wer(args) -> int:
    """(= decoderbin/compute-wer.cc)"""
    from eesen_tpu_torch.decoder.score import compute_wer

    def read_text(path):
        out = {}
        with open(path) as f:
            for line in f:
                parts = line.split()
                if parts:
                    out[parts[0]] = parts[1:]
        return out

    refs = read_text(args.ref)
    hyps = read_text(args.hyp)
    stats = compute_wer(refs, hyps, mode=args.mode)
    print(stats.report())
    return 0


def cmd_train(args) -> int:
    """Full CTC training from the shell on --device: newbob epochs,
    checkpoints, model blob out (= netbin/train-ctc-parallel.cc:30 driven
    by steps/train_ctc_parallel.sh's epoch loop, all in-process here).

    Features and labels come from rspecifiers (labels = int-vector ark,
    as prep_ctc_trans writes); cv sets drive the newbob halving."""
    from eesen_tpu_torch.training.batching import (
        BatchConfig, Utterance, make_batches,
    )
    from eesen_tpu_torch.training.optim import OptimizerConfig
    from eesen_tpu_torch.training.schedule import NewbobConfig
    from eesen_tpu_torch.training.trainer import Trainer, TrainerConfig

    dev = check_device(args.device)
    feats = {k: np.asarray(v, np.float32)
             for k, v in read_rspecifier(args.feats_rspecifier)}
    labels = {k: np.asarray(v, np.int32)
              for k, v in read_rspecifier(args.labels_rspecifier)}
    cv_feats = {k: np.asarray(v, np.float32)
                for k, v in read_rspecifier(args.cv_feats_rspecifier)}
    cv_labels = {k: np.asarray(v, np.int32)
                 for k, v in read_rspecifier(args.cv_labels_rspecifier)}
    if not feats:
        print("train: empty feature rspecifier", file=sys.stderr)
        return 1
    input_dim = next(iter(feats.values())).shape[1]
    model_cfg = AcousticModelConfig(
        input_dim=input_dim,
        cell_dim=args.cell_dim,
        num_layers=args.num_layers,
        num_targets=args.num_targets,
        param_range=args.param_range,
        fgate_bias=args.fgate_bias,
        forward_dropout=args.forward_dropout,
        recurrent_dropout=args.recurrent_dropout,
    )
    tcfg = TrainerConfig(
        model=model_cfg,
        optimizer=OptimizerConfig(
            algorithm=args.optimizer, momentum=args.momentum,
            max_grad=args.max_grad,
        ),
        newbob=NewbobConfig(
            learn_rate=args.learn_rate, max_iters=args.max_iters,
            min_iters=args.min_iters,
            start_halving_inc=args.start_halving_inc,
            end_halving_inc=args.end_halving_inc,
            halving_factor=args.halving_factor,
        ),
        report_step=args.report_step,
        checkpoint_dir=args.checkpoint_dir,
        loss=args.loss,
    )
    bcfg = BatchConfig(
        num_sequence=args.num_sequence, frame_limit=args.frame_limit,
        frame_labels=args.loss == "ce",
    )

    def mk(fd, ld):
        return [
            Utterance(k, fd[k], ld[k]) for k in sorted(fd)
            if k in ld and len(ld[k]) > 0
        ]

    tr_utts, cv_utts = mk(feats, labels), mk(cv_feats, cv_labels)
    trainer = Trainer(tcfg, device=dev)
    history = trainer.fit(
        lambda: make_batches(tr_utts, bcfg),
        lambda: make_batches(cv_utts, bcfg),
    )
    if args.label_counts:
        from eesen_tpu_torch.models.priors import counts_from_labels
        counts = counts_from_labels(
            [labels[u.key] for u in tr_utts], args.num_targets
        )
        np.savetxt(args.label_counts, counts)
    save_model_blob(args.model_out,
                    {"params": trainer.full_params(), "config": model_cfg})
    last = history[max(history)]
    print(
        f"train: {len(history)} epochs, final train_acc "
        f"{last.get('train_acc', float('nan')):.2f} cv_acc "
        f"{last.get('cv_acc', float('nan')):.2f}"
    )
    return 0


# --------------------------------------------------------------------------
# lattice archive tools (decoderbin/lattice-*.cc equivalents)
# --------------------------------------------------------------------------

def _lattice_items(path):
    from eesen_tpu_torch.decoder.lattice_io import read_lattice_ark
    yield from read_lattice_ark(path)


def _write_lattices(path, items, binary):
    from eesen_tpu_torch.decoder.lattice_io import write_lattice_ark
    write_lattice_ark(path, items, binary=binary)


def cmd_lattice_scale(args) -> int:
    """(= decoderbin/lattice-scale.cc)"""
    def gen():
        for key, lat in _lattice_items(args.in_ark):
            if hasattr(lat, "scaled"):
                lat = lat.scaled(args.acoustic_scale, args.lm_scale)
            else:
                lat.scale(args.acoustic_scale, args.lm_scale)
            yield key, lat
    _write_lattices(args.out_ark, gen(), args.binary)
    return 0


def cmd_lattice_prune(args) -> int:
    """(= decoderbin/lattice-prune.cc)"""
    def gen():
        for key, lat in _lattice_items(args.in_ark):
            lat.prune(args.beam)
            yield key, lat
    _write_lattices(args.out_ark, gen(), args.binary)
    return 0


def cmd_lattice_add_penalty(args) -> int:
    """(= decoderbin/lattice-add-penalty.cc)"""
    def gen():
        for key, lat in _lattice_items(args.in_ark):
            lat.add_penalty(args.word_ins_penalty)
            yield key, lat
    _write_lattices(args.out_ark, gen(), args.binary)
    return 0


def cmd_lattice_copy(args) -> int:
    """(= fstcopy/lattice-copy: text<->binary conversion)"""
    _write_lattices(args.out_ark, _lattice_items(args.in_ark), args.binary)
    return 0


def cmd_lattice_best_path(args) -> int:
    """(= decoderbin/lattice-best-path.cc): transcripts to stdout/file."""
    words = _symbols(args.words)
    out_f = _out_file(args.out)
    for key, lat in _lattice_items(args.in_ark):
        if hasattr(lat, "scaled"):
            lat = lat.scaled(args.acoustic_scale, args.lm_scale)
        else:
            lat.scale(args.acoustic_scale, args.lm_scale)
        _, wids, _ = lat.best_path()
        out_f.write(f"{key} {_text(words, wids)}\n")
    _close(out_f)
    return 0


def cmd_lattice_to_nbest(args) -> int:
    """(= decoderbin/lattice-to-nbest.cc): `key-N words` lines."""
    from eesen_tpu_torch.decoder.clat import compact_to_lattice

    words = _symbols(args.words)
    out_f = _out_file(args.out)
    for key, lat in _lattice_items(args.in_ark):
        if hasattr(lat, "scaled"):
            lat = compact_to_lattice(lat)
        for i, (wids, _) in enumerate(lat.nbest(args.n), 1):
            out_f.write(f"{key}-{i} {_text(words, wids)}\n")
    _close(out_f)
    return 0


def cmd_lattice_1best(args) -> int:
    """(= decoderbin/lattice-1best.cc): keep only the best path of each
    lattice (costs preserved per arc)."""
    from eesen_tpu_torch.decoder.clat import compact_to_lattice

    def gen():
        for key, lat in _lattice_items(args.in_ark):
            if hasattr(lat, "scaled"):
                lat = compact_to_lattice(lat)
            lat.scale(args.acoustic_scale, args.lm_scale)
            best = lat.one_best()
            best.scale(
                1.0 / args.acoustic_scale if args.acoustic_scale else 1.0,
                1.0 / args.lm_scale if args.lm_scale else 1.0,
            )
            yield key, best

    _write_lattices(args.out_ark, gen(), args.binary)
    return 0


def cmd_arpa_to_const_lm(args) -> int:
    """Build the compact const-arpa trie from ARPA text and write the
    mmap-able .npz image (reference: ConstArpaLm Write,
    src/lm/const-arpa-lm.h:82)."""
    import gzip

    from eesen_tpu_torch.decoder.const_arpa import ConstArpa

    opener = gzip.open if args.arpa.endswith(".gz") else open
    with opener(args.arpa, "rt") as f:
        text = f.read()
    trie = ConstArpa.from_arpa(text, _symbols(args.words))
    trie.save(args.out)
    print(
        f"const-arpa: order {trie.order}, {trie.num_ngrams} ngrams, "
        f"{trie.num_states} states, {trie.bytes()} bytes -> {args.out}",
        file=sys.stderr,
    )
    return 0


def cmd_lattice_rescore(args) -> int:
    """Rescore lattice archives with a bigger LM: either a const-arpa
    .npz image (mmap-loaded) or ARPA text (via the G-fst automaton).
    Replaces `lm_scale_old` of the graph cost with the new LM's score
    (the reference's ConstArpaLmDeterministicFst composition,
    src/lm/const-arpa-lm.h:202)."""
    from eesen_tpu_torch.decoder.clat import (
        compact_to_lattice, determinize_lattice_pruned,
    )
    from eesen_tpu_torch.decoder.rescore import rescore_lattice

    if args.lm.endswith(".npz"):
        from eesen_tpu_torch.decoder.const_arpa import ConstArpa
        lm = ConstArpa.load(args.lm, mmap=True)
    else:
        import gzip

        from eesen_tpu_torch.decoder.arpa import arpa_to_fst
        from eesen_tpu_torch.decoder.rescore import LmAutomaton
        opener = gzip.open if args.lm.endswith(".gz") else open
        with opener(args.lm, "rt") as f:
            text = f.read()
        words = _symbols(args.words)
        g = arpa_to_fst(text, words)
        bo = words["#0"] if "#0" in words else None
        lm = LmAutomaton(g, backoff_ilabel=bo)

    def gen():
        for key, lat in _lattice_items(args.in_ark):
            if hasattr(lat, "scaled"):
                lat = compact_to_lattice(lat)
            out = rescore_lattice(
                lat, lm, lm_scale_new=args.lm_scale,
                old_graph_scale=args.old_graph_scale,
            )
            yield key, determinize_lattice_pruned(out)

    _write_lattices(args.out_ark, gen(), args.binary)
    return 0


def cmd_lattice_confidence(args) -> int:
    """Sentence-level confidence: best-vs-second-best total-cost margin
    per utterance (lat/confidence.cc SentenceLevelConfidence, surfaced as
    `key confidence num_paths` lines)."""
    from eesen_tpu_torch.decoder.clat import (
        sentence_confidence, sentence_confidence_lattice,
    )

    out_f = _out_file(args.out)
    for key, lat in _lattice_items(args.in_ark):
        if hasattr(lat, "scaled"):   # CompactLattice (determinized)
            lat = lat.scaled(args.acoustic_scale, args.lm_scale)
            conf, n, _, _ = sentence_confidence(lat)
        else:
            lat.scale(args.acoustic_scale, args.lm_scale)
            conf, n, _, _ = sentence_confidence_lattice(lat)
        out_f.write(f"{key} {conf:.6g} {n}\n")
    _close(out_f)
    return 0


def cmd_nbest_to_ctm(args) -> int:
    """(= decoderbin/nbest-to-ctm.cc): best-path word time boundaries in
    CTM format (word start at its olabel frame)."""
    from eesen_tpu_torch.decoder.clat import compact_to_lattice

    words = _symbols(args.words)
    out_f = _out_file(args.out)
    for key, lat in _lattice_items(args.in_ark):
        if hasattr(lat, "scaled"):
            lat = compact_to_lattice(lat)
        for (w, s, e) in lat.word_times():
            name = words.sym(w) if words else str(w)
            dur = max(e - s, 1) * args.frame_shift
            out_f.write(
                f"{key} 1 {s * args.frame_shift:.2f} {dur:.2f} {name}\n"
            )
    _close(out_f)
    return 0


def cmd_analyze_counts(args) -> int:
    """(= decoderbin/analyze-counts.cc): class frame counts from label
    int-vectors, for class priors."""
    from eesen_tpu_torch.models.priors import counts_from_labels

    seqs = [np.asarray(v, np.int64)
            for _, v in read_rspecifier(args.labels_rspecifier)]
    counts = counts_from_labels(seqs, args.num_targets)
    np.savetxt(args.out, counts)
    return 0


def cmd_arpa2fst(args) -> int:
    """(= decoderbin/arpa2fst.cc): ARPA LM -> G fst (OpenFst text)."""
    from eesen_tpu_torch.decoder.arpa import arpa_to_fst

    g = arpa_to_fst(args.arpa, _symbols(args.words),
                    disambig_symbol=args.disambig_symbol)
    out_f = _out_file(args.out)
    out_f.write(g.to_text())
    _close(out_f)
    return 0


# --------------------------------------------------------------------------
# fstbin equivalents over OpenFst-text files ("-" = stdin/stdout, so the
# reference's shell pipelines port directly)
# --------------------------------------------------------------------------

def _read_text_fst(path):
    from eesen_tpu_torch.decoder.fst import Fst
    if path == "-":
        return Fst.from_text(sys.stdin.read())
    with open(path) as f:
        return Fst.from_text(f.read())


def _write_text_fst(f, path) -> int:
    out_f = _out_file(path)
    out_f.write(f.to_text())
    _close(out_f)
    return 0


def cmd_fst_unary(args, op: str) -> int:
    """fstcopy / fstdeterminizestar / fstdeterminizelog /
    fstminimizeencoded / fstrmepsilon / fstpushspecial / fstconnect /
    fstarcsort over text FSTs (native C++ dispatch when built)."""
    from eesen_tpu_torch.decoder import fst as pyfst
    from eesen_tpu_torch.decoder import fst_native as nat

    f = _read_text_fst(args.in_fst)
    if op == "copy":
        g = f
    elif op == "determinize-star":
        g = nat.determinize_star(f, "tropical")
    elif op == "determinize-log":
        g = nat.determinize_star(f, "log")
    elif op == "minimize-encoded":
        g = nat.minimize_encoded(f)
    elif op == "rm-epsilon":
        g = nat.rm_epsilon(f, args.semiring)
    elif op == "push-special":
        g = pyfst.push_special(f, delta=args.delta)
    elif op == "connect":
        g = nat.connect(f)
    elif op == "arcsort":
        g = pyfst.arcsort(f, args.sort_type)
    else:
        raise ValueError(op)
    return _write_text_fst(g, args.out_fst)


def cmd_fst_add_subsequential_loop(args) -> int:
    """(= fstbin/fstaddsubsequentialloop.cc)."""
    from eesen_tpu_torch.decoder.fst import add_subsequential_loop

    f = _read_text_fst(args.in_fst)
    return _write_text_fst(
        add_subsequential_loop(f, args.subseq_sym), args.out_fst
    )


def cmd_fst_factor(args) -> int:
    """(= fstbin/fstfactor.cc): factor linear input chains into new
    symbols; writes the left factor FST to out1 and the factored FST to
    out2 (their composition is equivalent to the input)."""
    from eesen_tpu_torch.decoder.fst import create_factor_fst, factor

    f = _read_text_fst(args.in_fst)
    g, symbols = factor(f)
    _write_text_fst(create_factor_fst(symbols), args.out1)
    return _write_text_fst(g, args.out2)


def cmd_fst_prune_special(args) -> int:
    """(= fstext/prune-special.h PruneSpecial as a tool): keep only
    paths within --beam of the best, optionally capping --max-states."""
    from eesen_tpu_torch.decoder.fst import prune_special

    f = _read_text_fst(args.in_fst)
    return _write_text_fst(
        prune_special(f, args.beam, args.max_states), args.out_fst
    )


def cmd_fst_compose(args) -> int:
    """fsttablecompose / fstphicompose / fstrhocompose over text FSTs."""
    from eesen_tpu_torch.decoder import fst as pyfst
    from eesen_tpu_torch.decoder import fst_native as nat

    a = _read_text_fst(args.a)
    b = _read_text_fst(args.b)
    if args.phi:
        g = pyfst.phi_compose(a, b, args.phi)
    elif args.rho:
        g = pyfst.rho_compose(a, b, args.rho)
    else:
        g = nat.compose(pyfst.arcsort(a, "olabel"), b)
    return _write_text_fst(g, args.out_fst)


def cmd_fst_add_self_loops(args) -> int:
    """(= fstbin/fstaddselfloops.cc)."""
    from eesen_tpu_torch.decoder.fst import add_self_loops

    f = _read_text_fst(args.in_fst)
    isyms = [int(x) for x in args.isyms.split(",") if x]
    osyms = [int(x) for x in args.osyms.split(",") if x]
    return _write_text_fst(add_self_loops(f, isyms, osyms), args.out_fst)


def cmd_fst_is_stochastic(args) -> int:
    """(= fstbin/fstisstochastic.cc): prints min/max residual; exit 0
    iff stochastic within delta."""
    from eesen_tpu_torch.decoder.fst import is_stochastic

    ok, lo, hi = is_stochastic(_read_text_fst(args.in_fst), args.delta)
    print(f"{lo:.6g} {hi:.6g}")
    return 0 if ok else 1


def cmd_lattice_to_ctm_conf(args) -> int:
    """(= decoderbin/lattice-to-ctm-conf.cc): MBR one-best with
    confidences in CTM format."""
    from eesen_tpu_torch.decoder.clat import compact_to_lattice
    from eesen_tpu_torch.decoder.sausages import minimum_bayes_risk

    words = _symbols(args.words)
    out_f = _out_file(args.out)
    for key, lat in _lattice_items(args.in_ark):
        if hasattr(lat, "scaled"):
            lat = compact_to_lattice(lat)
        mbr = minimum_bayes_risk(lat)
        if mbr is None:
            continue
        for (w, conf, (s, e)) in zip(
            mbr.words, mbr.confidences, mbr.times
        ):
            name = words.sym(w) if words else str(w)
            dur = max(e - s, 1) * args.frame_shift
            out_f.write(
                f"{key} 1 {s * args.frame_shift:.2f} {dur:.2f} "
                f"{name} {conf:.3f}\n"
            )
    _close(out_f)
    return 0


def cmd_fst_rm_symbols(args) -> int:
    """(= fstbin/fstrmsymbols.cc): replace listed symbols with eps."""
    from eesen_tpu_torch.decoder.fst import rm_symbols

    with open(args.symbols_list) as f:
        syms = [int(line.split()[0]) for line in f if line.strip()]
    g = rm_symbols(
        _read_text_fst(args.in_fst), syms,
        from_output=args.remove_from_output,
    )
    return _write_text_fst(g, args.out_fst)


def cmd_fst_prop_final(args) -> int:
    """(= fstbin/fstpropfinal.cc): propagate final weights through
    phi-label arcs."""
    from eesen_tpu_torch.decoder.fst import propagate_final

    g = propagate_final(_read_text_fst(args.in_fst), args.phi_label)
    return _write_text_fst(g, args.out_fst)


def cmd_fst_rand(args) -> int:
    """(= fstbin/fstrand.cc): emit a random FST (for property tests)."""
    import random

    from eesen_tpu_torch.decoder.fst import rand_fst

    g = rand_fst(
        random.Random(args.seed), n_states=args.n_states,
        n_arcs=args.n_arcs, n_syms=args.n_syms,
        acyclic=not args.allow_cycles,
    )
    return _write_text_fst(g, args.out_fst)


def _read_fst_archive(path):
    """Kaldi text-mode FST archive: `key\\n<fst text>\\n\\n` records."""
    from eesen_tpu_torch.decoder.fst import Fst

    f = sys.stdin if path in ("-", "ark:-") else open(
        path.split(":", 1)[-1]
    )
    try:
        key, buf = None, []
        for line in f:
            if key is None:
                line = line.strip()
                if line:
                    key = line
                continue
            if line.strip():
                buf.append(line)
            else:
                yield key, Fst.from_text("".join(buf))
                key, buf = None, []
        if key is not None and buf:
            yield key, Fst.from_text("".join(buf))
    finally:
        if f is not sys.stdin:
            f.close()


def cmd_fsts_to_transcripts(args) -> int:
    """(= fstbin/fsts-to-transcripts.cc): best path per archived FST,
    print its output-side (default) or input-side symbol sequence."""
    from eesen_tpu_torch.decoder.fst import shortest_path

    out_f = _out_file(args.out)
    for key, f in _read_fst_archive(args.fsts):
        try:
            il, ol, _ = shortest_path(f)
        except Exception:
            print(f"fsts-to-transcripts: no path for {key}",
                  file=sys.stderr)
            continue
        seq = ol if args.output_side else il
        out_f.write(key + " " + " ".join(str(x) for x in seq) + "\n")
    _close(out_f)
    return 0


def cmd_net_initialize(args) -> int:
    """(= netbin/net-initialize.cc): random-init a model from an
    nnet.proto topology (models/proto.py format).  The parameters are
    drawn from torch.Generator().manual_seed(--seed), on the host."""
    from eesen_tpu_torch.models.model import init_model, model_num_params
    from eesen_tpu_torch.models.proto import parse_nnet_proto

    with open(args.proto) as f:
        cfg = parse_nnet_proto(f.read())
    params = init_model(torch.Generator().manual_seed(args.seed), cfg,
                        device="cpu")
    _write_model(args.out, params, cfg, args.parallel)
    print(f"net-initialize: {args.proto} -> {args.out} "
          f"({model_num_params(params)} params)")
    return 0


def cmd_model_topo(args) -> int:
    """(= utils/model_topo.py): emit an nnet.proto topology."""
    from eesen_tpu_torch.models.proto import emit_nnet_proto

    cfg = AcousticModelConfig(
        input_dim=args.input_feat_dim,
        cell_dim=args.lstm_cell_dim,
        num_layers=args.lstm_layer_num,
        num_targets=args.target_num,
        param_range=args.param_range,
        fgate_bias=args.fgate_bias_init,
    )
    text = emit_nnet_proto(cfg, max_grad=args.max_grad)
    if args.out == "-":
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


# --------------------------------------------------------------------------
# argument wiring (the JAX package's, plus the top-level --device)
# --------------------------------------------------------------------------

def _add_frame_args(p):
    p.add_argument("--sample-frequency", type=float, default=16000.0)
    p.add_argument("--frame-shift", type=float, default=10.0)
    p.add_argument("--frame-length", type=float, default=25.0)
    p.add_argument("--dither", type=float, default=1.0)
    p.add_argument("--preemphasis-coefficient", type=float, default=0.97)
    p.add_argument("--window-type", default="povey")
    p.add_argument("--num-mel-bins", type=int, default=23)
    p.add_argument("--use-energy", action="store_true")
    p.add_argument("--vtln-warp", type=float, default=1.0)
    p.add_argument("--channel", type=int, default=0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="eesen-tpu-torch")
    parser.add_argument(
        "--device", default="cuda",
        help="where the computing commands run (features, net-output-"
             "extract, latgen, decode-faster, align, train): 'cuda' "
             "(default; raises without a card) or 'cpu'",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    for kind in ("fbank", "mfcc", "plp", "spectrogram"):
        p = sub.add_parser(f"compute-{kind}-feats")
        _add_frame_args(p)
        if kind == "mfcc":
            p.add_argument("--num-ceps", type=int, default=13)
        p.add_argument("wav_rspecifier")
        p.add_argument("feats_wspecifier")
        p.set_defaults(func=lambda a, k=kind: cmd_compute_feats(a, k))

    p = sub.add_parser("compute-cmvn-stats")
    p.add_argument("--spk2utt", default="")
    p.add_argument("feats_rspecifier")
    p.add_argument("stats_wspecifier")
    p.set_defaults(func=cmd_compute_cmvn_stats)

    p = sub.add_parser("apply-cmvn")
    p.add_argument("--utt2spk", default="")
    p.add_argument("--norm-vars", type=lambda s: s == "true", default=True)
    p.add_argument("stats_rspecifier")
    p.add_argument("feats_rspecifier")
    p.add_argument("feats_wspecifier")
    p.set_defaults(func=cmd_apply_cmvn)

    p = sub.add_parser("add-deltas")
    p.add_argument("--delta-order", type=int, default=2)
    p.add_argument("--delta-window", type=int, default=2)
    p.add_argument("feats_rspecifier")
    p.add_argument("feats_wspecifier")
    p.set_defaults(func=cmd_add_deltas)

    p = sub.add_parser("splice-feats")
    p.add_argument("--left-context", type=int, default=4)
    p.add_argument("--right-context", type=int, default=4)
    p.add_argument("feats_rspecifier")
    p.add_argument("feats_wspecifier")
    p.set_defaults(func=cmd_splice_feats)

    p = sub.add_parser("subsample-feats")
    p.add_argument("--n", type=int, default=1)
    p.add_argument("--offset", type=int, default=0)
    p.add_argument("feats_rspecifier")
    p.add_argument("feats_wspecifier")
    p.set_defaults(func=cmd_subsample_feats)

    p = sub.add_parser("copy-feats")
    p.add_argument("feats_rspecifier")
    p.add_argument("feats_wspecifier")
    p.set_defaults(func=cmd_copy_feats)

    p = sub.add_parser("paste-feats")
    p.add_argument("in_rspecifiers", nargs="+")
    p.add_argument("feats_wspecifier")
    p.set_defaults(func=cmd_paste_feats)

    p = sub.add_parser("extract-segments")
    p.add_argument("wav_rspecifier")
    p.add_argument("segments")
    p.add_argument("wav_wspecifier")
    p.set_defaults(func=cmd_extract_segments)

    p = sub.add_parser("compute-kaldi-pitch-feats")
    p.add_argument("--sample-frequency", type=float, default=16000.0)
    p.add_argument("--min-f0", type=float, default=50.0)
    p.add_argument("--max-f0", type=float, default=400.0)
    p.add_argument("wav_rspecifier")
    p.add_argument("feats_wspecifier")
    p.set_defaults(func=cmd_compute_pitch)

    p = sub.add_parser("feat-to-dim")
    p.add_argument("feats_rspecifier")
    p.set_defaults(func=cmd_feat_to_dim)

    p = sub.add_parser("feat-to-len")
    p.add_argument("feats_rspecifier")
    p.set_defaults(func=cmd_feat_to_len)

    p = sub.add_parser("prep-corpus")
    p.add_argument("corpus", choices=["librispeech", "wsj", "tedlium",
                                      "swbd1", "hkust"])
    p.add_argument("dst", help="output data dir (root)")
    p.add_argument("src", nargs="+",
                   help="corpus tree(s): librispeech/tedlium/swbd1 one "
                        "dir; wsj the disk dirs; hkust <audio> <text>")
    p.add_argument("--trans-dir", default=None,
                   help="swbd1: external transcript dir")
    p.set_defaults(func=cmd_prep_corpus)

    p = sub.add_parser("build-lang")
    p.add_argument("--dict-type", default="phn", choices=["phn", "char"])
    p.add_argument("--space-char", default="<SPACE>")
    p.add_argument("lexicon")
    p.add_argument("units")
    p.add_argument("out_dir")
    p.set_defaults(func=cmd_build_lang)

    p = sub.add_parser("build-tlg")
    p.add_argument("--max-degree", type=int, default=16)
    p.add_argument("lang_dir")
    p.add_argument("arpa")
    p.add_argument("out")
    p.set_defaults(func=cmd_build_tlg)

    p = sub.add_parser("net-output-extract")
    p.add_argument("--class-frame-counts", default="")
    p.add_argument("--prior-scale", type=float, default=1.0)
    p.add_argument("--blank-scale", type=float, default=1.0)
    p.add_argument("model")
    p.add_argument("feats_rspecifier")
    p.add_argument("out_wspecifier")
    p.set_defaults(func=cmd_net_output_extract)

    p = sub.add_parser("latgen")
    p.add_argument("--beam", type=float, default=17.0)
    p.add_argument("--max-active", type=int, default=4096)
    p.add_argument("--acoustic-scale", type=float, default=0.9)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--words", default="")
    p.add_argument("--lattice-ark", default=None,
                   help="also write determinized CompactLattices here")
    p.add_argument("--lattice-beam", type=float, default=8.0)
    p.add_argument("--binary", action="store_true",
                   help="binary lattice archive")
    p.add_argument("--blank-skip", type=float, default=0.0,
                   help="skip frames with blank posterior above this "
                        "(phone-synchronous decoding; 0 disables)")
    p.add_argument("--streaming", action="store_true",
                   help="chunked online decode with carried search "
                        "state (results identical to offline)")
    p.add_argument("--chunk-frames", type=int, default=32,
                   help="frames per streaming chunk")
    p.add_argument("graph")
    p.add_argument("loglikes_rspecifier")
    p.add_argument("out")
    p.set_defaults(func=cmd_latgen)

    p = sub.add_parser("decode-faster")
    p.add_argument("--acoustic-scale", type=float, default=0.9)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--in-degree", type=int, default=16)
    p.add_argument("--words", default="")
    p.add_argument("graph")
    p.add_argument("loglikes_rspecifier")
    p.add_argument("out")
    p.set_defaults(func=cmd_decode_faster)

    p = sub.add_parser("compute-wer")
    p.add_argument("--mode", default="present", choices=["present", "all"])
    p.add_argument("ref")
    p.add_argument("hyp")
    p.set_defaults(func=cmd_compute_wer)

    p = sub.add_parser("model-info")
    p.add_argument("model")
    p.set_defaults(func=cmd_model_info)

    p = sub.add_parser("net-average")
    p.add_argument("out")
    p.add_argument("models", nargs="+")
    p.set_defaults(func=cmd_net_average)

    p = sub.add_parser("net-copy")
    p.add_argument("--parallel", action="store_true")
    p.add_argument("src")
    p.add_argument("dst")
    p.set_defaults(func=cmd_net_copy)

    p = sub.add_parser(
        "net-change-model",
        help="rewrite dropout hyperparameters of a saved model "
             "(netbin/net-change-model)",
    )
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--forwarddrop", type=float, default=None)
    p.add_argument("--recurrentdrop", type=float, default=None)
    p.add_argument("--forwardstep", type=lambda s: s == "true",
                   default=None)
    p.add_argument("--recurrentstep", type=lambda s: s == "true",
                   default=None)
    p.add_argument("--rnndrop", action="store_true")
    p.add_argument("--nmldrop", action="store_true")
    p.add_argument("--twiddleforward", type=lambda s: s == "true",
                   default=None)
    p.add_argument("--parallel", action="store_true")
    p.set_defaults(func=cmd_net_change_model)

    p = sub.add_parser("align")
    p.add_argument("model")
    p.add_argument("feats_rspecifier")
    p.add_argument("labels_rspecifier")
    p.add_argument("out")
    p.set_defaults(func=cmd_align)

    p = sub.add_parser(
        "train",
        help="CTC or CE training with newbob schedule "
             "(train-ctc-parallel / train-ce-parallel)",
    )
    p.add_argument("--loss", default="ctc", choices=["ctc", "ce"],
                   help="ce trains on frame-aligned labels "
                        "(netbin/train-ce-parallel.cc)")
    p.add_argument("feats_rspecifier")
    p.add_argument("labels_rspecifier")
    p.add_argument("cv_feats_rspecifier")
    p.add_argument("cv_labels_rspecifier")
    p.add_argument("model_out")
    p.add_argument("--num-targets", type=int, required=True)
    p.add_argument("--cell-dim", type=int, default=320)
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--param-range", type=float, default=0.1)
    p.add_argument("--fgate-bias", type=float, default=0.0)
    p.add_argument("--forward-dropout", type=float, default=0.0)
    p.add_argument("--recurrent-dropout", type=float, default=0.0)
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "adagrad", "rmsprop"])
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--max-grad", type=float, default=50.0)
    p.add_argument("--learn-rate", type=float, default=4e-5)
    p.add_argument("--max-iters", type=int, default=25)
    p.add_argument("--min-iters", type=int, default=None)
    p.add_argument("--start-halving-inc", type=float, default=0.5)
    p.add_argument("--end-halving-inc", type=float, default=0.1)
    p.add_argument("--halving-factor", type=float, default=0.5)
    p.add_argument("--num-sequence", type=int, default=16)
    p.add_argument("--frame-limit", type=int, default=100000)
    p.add_argument("--report-step", type=int, default=100)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--label-counts", default=None,
                   help="write class frame counts for priors")
    p.set_defaults(func=cmd_train)

    def _lat_io(p, scale=False):
        p.add_argument("in_ark")
        p.add_argument("out_ark")
        p.add_argument("--binary", action="store_true")
        if scale:
            p.add_argument("--acoustic-scale", type=float, default=1.0)
            p.add_argument("--lm-scale", type=float, default=1.0)

    p = sub.add_parser("lattice-scale")
    _lat_io(p, scale=True)
    p.set_defaults(func=cmd_lattice_scale)

    p = sub.add_parser("lattice-prune")
    _lat_io(p)
    p.add_argument("--beam", type=float, default=8.0)
    p.set_defaults(func=cmd_lattice_prune)

    p = sub.add_parser("lattice-add-penalty")
    _lat_io(p)
    p.add_argument("--word-ins-penalty", type=float, default=0.0)
    p.set_defaults(func=cmd_lattice_add_penalty)

    p = sub.add_parser("lattice-copy")
    _lat_io(p)
    p.set_defaults(func=cmd_lattice_copy)

    p = sub.add_parser("lattice-best-path")
    p.add_argument("in_ark")
    p.add_argument("--out", default="-")
    p.add_argument("--words", default=None)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--lm-scale", type=float, default=1.0)
    p.set_defaults(func=cmd_lattice_best_path)

    p = sub.add_parser("lattice-to-nbest")
    p.add_argument("in_ark")
    p.add_argument("--out", default="-")
    p.add_argument("--words", default=None)
    p.add_argument("--n", type=int, default=10)
    p.set_defaults(func=cmd_lattice_to_nbest)

    p = sub.add_parser("lattice-to-ctm-conf")
    p.add_argument("in_ark")
    p.add_argument("--out", default="-")
    p.add_argument("--words", default=None)
    p.add_argument("--frame-shift", type=float, default=0.01)
    p.set_defaults(func=cmd_lattice_to_ctm_conf)

    p = sub.add_parser("lattice-1best")
    _lat_io(p, scale=True)
    p.set_defaults(func=cmd_lattice_1best)

    p = sub.add_parser("arpa-to-const-lm")
    p.add_argument("arpa")
    p.add_argument("words")
    p.add_argument("out")
    p.set_defaults(func=cmd_arpa_to_const_lm)

    p = sub.add_parser("lattice-rescore")
    p.add_argument("in_ark")
    p.add_argument("lm", help=".npz const-arpa image or ARPA text(.gz)")
    p.add_argument("out_ark")
    p.add_argument("--words", default="",
                   help="words.txt (needed for ARPA text input)")
    p.add_argument("--lm-scale", type=float, default=1.0)
    p.add_argument("--old-graph-scale", type=float, default=0.0)
    p.add_argument("--binary", action="store_true")
    p.set_defaults(func=cmd_lattice_rescore)

    p = sub.add_parser("lattice-confidence")
    p.add_argument("in_ark")
    p.add_argument("--out", default="-")
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--lm-scale", type=float, default=1.0)
    p.set_defaults(func=cmd_lattice_confidence)

    p = sub.add_parser("nbest-to-ctm")
    p.add_argument("in_ark")
    p.add_argument("--out", default="-")
    p.add_argument("--words", default=None)
    p.add_argument("--frame-shift", type=float, default=0.01)
    p.set_defaults(func=cmd_nbest_to_ctm)

    p = sub.add_parser("analyze-counts")
    p.add_argument("labels_rspecifier")
    p.add_argument("out")
    p.add_argument("--num-targets", type=int, required=True)
    p.set_defaults(func=cmd_analyze_counts)

    p = sub.add_parser("arpa2fst")
    p.add_argument("arpa")
    p.add_argument("--out", default="-")
    p.add_argument("--words", default=None)
    p.add_argument("--disambig-symbol", default="#0")
    p.set_defaults(func=cmd_arpa2fst)

    for name, op in [
        ("fst-copy", "copy"),
        ("fst-determinize-star", "determinize-star"),
        ("fst-determinize-log", "determinize-log"),
        ("fst-minimize-encoded", "minimize-encoded"),
        ("fst-rm-epsilon", "rm-epsilon"),
        ("fst-push-special", "push-special"),
        ("fst-connect", "connect"),
        ("fst-arcsort", "arcsort"),
    ]:
        p = sub.add_parser(
            name, help=f"fstbin {op} over OpenFst-text FSTs",
        )
        p.add_argument("in_fst")
        p.add_argument("out_fst", nargs="?", default="-")
        p.add_argument("--semiring", default="tropical",
                       choices=["tropical", "log"])
        p.add_argument("--delta", type=float, default=1e-3)
        p.add_argument("--sort-type", default="ilabel",
                       choices=["ilabel", "olabel"])
        p.set_defaults(func=lambda a, op=op: cmd_fst_unary(a, op))

    p = sub.add_parser(
        "fst-compose",
        help="fsttablecompose / fstphicompose / fstrhocompose",
    )
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("out_fst", nargs="?", default="-")
    p.add_argument("--phi", type=int, default=0)
    p.add_argument("--rho", type=int, default=0)
    p.set_defaults(func=cmd_fst_compose)

    p = sub.add_parser("fst-add-self-loops")
    p.add_argument("in_fst")
    p.add_argument("out_fst", nargs="?", default="-")
    p.add_argument("--isyms", required=True)
    p.add_argument("--osyms", required=True)
    p.set_defaults(func=cmd_fst_add_self_loops)

    p = sub.add_parser(
        "fst-add-subsequential-loop",
        help="add the subsequential '$' loop (fstaddsubsequentialloop)",
    )
    p.add_argument("subseq_sym", type=int)
    p.add_argument("in_fst", nargs="?", default="-")
    p.add_argument("out_fst", nargs="?", default="-")
    p.set_defaults(func=cmd_fst_add_subsequential_loop)

    p = sub.add_parser(
        "fst-factor",
        help="factor linear input chains into new symbols (fstfactor)",
    )
    p.add_argument("in_fst")
    p.add_argument("out1")
    p.add_argument("out2", nargs="?", default="-")
    p.set_defaults(func=cmd_fst_factor)

    p = sub.add_parser(
        "fst-prune-special",
        help="prune to paths within --beam of the best "
             "(fstext/prune-special.h)",
    )
    p.add_argument("in_fst")
    p.add_argument("out_fst", nargs="?", default="-")
    p.add_argument("--beam", type=float, default=4.0)
    p.add_argument("--max-states", type=int, default=0)
    p.set_defaults(func=cmd_fst_prune_special)

    p = sub.add_parser("fst-is-stochastic")
    p.add_argument("in_fst")
    p.add_argument("--delta", type=float, default=0.01)
    p.set_defaults(func=cmd_fst_is_stochastic)

    p = sub.add_parser(
        "fst-rm-symbols",
        help="replace listed symbols with epsilon (fstbin/fstrmsymbols)",
    )
    p.add_argument("symbols_list")
    p.add_argument("in_fst")
    p.add_argument("out_fst", nargs="?", default="-")
    p.add_argument("--remove-from-output", action="store_true")
    p.set_defaults(func=cmd_fst_rm_symbols)

    p = sub.add_parser(
        "fst-prop-final",
        help="propagate final weights through phi arcs "
             "(fstbin/fstpropfinal)",
    )
    p.add_argument("phi_label", type=int)
    p.add_argument("in_fst")
    p.add_argument("out_fst", nargs="?", default="-")
    p.set_defaults(func=cmd_fst_prop_final)

    p = sub.add_parser("fst-rand", help="random FST (fstbin/fstrand)")
    p.add_argument("out_fst", nargs="?", default="-")
    p.add_argument("--n-states", type=int, default=8)
    p.add_argument("--n-arcs", type=int, default=16)
    p.add_argument("--n-syms", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--allow-cycles", action="store_true")
    p.set_defaults(func=cmd_fst_rand)

    p = sub.add_parser(
        "fsts-to-transcripts",
        help="best-path symbol sequences from a text FST archive "
             "(fstbin/fsts-to-transcripts)",
    )
    p.add_argument("fsts")
    p.add_argument("out", nargs="?", default="-")
    p.add_argument("--output-side", type=lambda s: s != "false",
                   default=True)
    p.set_defaults(func=cmd_fsts_to_transcripts)

    p = sub.add_parser(
        "net-initialize",
        help="random-init a model from nnet.proto "
             "(netbin/net-initialize)",
    )
    p.add_argument("proto")
    p.add_argument("out")
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--parallel", action="store_true")
    p.set_defaults(func=cmd_net_initialize)

    p = sub.add_parser(
        "model-topo", help="emit nnet.proto (utils/model_topo.py)",
    )
    p.add_argument("--input-feat-dim", type=int, required=True)
    p.add_argument("--lstm-layer-num", type=int, required=True)
    p.add_argument("--lstm-cell-dim", type=int, required=True)
    p.add_argument("--target-num", type=int, required=True)
    p.add_argument("--param-range", type=float, default=0.1)
    p.add_argument("--fgate-bias-init", type=float, default=0.0)
    p.add_argument("--max-grad", type=float, default=50.0)
    p.add_argument("--out", default="-")
    p.set_defaults(func=cmd_model_topo)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
