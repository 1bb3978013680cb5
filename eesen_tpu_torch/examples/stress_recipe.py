"""Hard synthetic stress run: 20k-word vocabulary, trigram LM, LM-scale
TLG, noise/speaker/rate variability, homophones and OOVs in eval
(counterpart of the JAX package's examples/stress_recipe.py).

The hardest available proxy for real-corpus validation (no LDC/OpenSLR
data ships with the repo): where the flagship synth run
(examples/synth_recipe.py) is a 2 h / 500-word sanity pipeline, this run
stresses the parts that run was too easy to exercise:

- ~20 h of audio, 64 speakers, per-utterance SNR drawn from [8, 25] dB;
- 20,000-word lexicon with 400 HOMOPHONE pairs (identical prons, distinct
  words — disambig symbols + the LM must separate them);
- eval utterances contain ~2.5% OOV tokens (synthesized from real prons
  but absent from the lexicon/LM — unrecognizable by construction);
- text follows a class-conditioned Markov process so the trigram LM has
  genuine predictive power over the bigram/unigram (acwt actually moves);
- trigram LM (estimate_ngram_arpa) at LM scale -> multi-million-state
  TLG via the native one-call build; the compiled graph and pron rows are
  cached as .npz (BENCH_GRAPH_CACHE) for an LM-scale decode benchmark;
- parity checks the easy corpus could not stress: acwt sweep (lattice
  rescale) == direct re-decode, blank-skip == full decode on hard
  content, plus the automatic blank-skip guard, and const-arpa rescoring
  against the G-fst automaton.

Synthesis, the lexicon, the texts, the LM, G and the TLG are host numpy
and C++ from numpy seeds (the JAX package's bytes); features, training
and the search run on `--device` ("cuda" by default: fbank in torch ops,
the LSTM, CTC and recombination kernels).  Each stage's wall seconds,
kernel launches, span seconds (utils/profile.SPANS) and peak device
memory go to results.json ("stages").
Reference pipeline shape: asr_egs/wsj/run_ctc_phn.sh:21-97.

Usage: python -m eesen_tpu_torch.examples.stress_recipe [workdir]
           [--utts N] [--cv N] [--eval N] [--lm-sents N] [--hard]
           [--epoch-repeat N] [--stop-after synth|feats] [--augment]
           [--device cuda|cpu]
"""

import argparse
import dataclasses
import gzip
import json
import multiprocessing
import os
import pickle
import tempfile
import time

import numpy as np

from eesen_tpu_torch.decoder.arpa import arpa_to_fst
from eesen_tpu_torch.decoder.beam import BeamSearchConfig, DeviceGraph
from eesen_tpu_torch.decoder.clat import compact_to_lattice
from eesen_tpu_torch.decoder.const_arpa import ConstArpa
from eesen_tpu_torch.decoder.ctc_graph import build_full_compiled
from eesen_tpu_torch.decoder.graph_compile import CompiledGraph
from eesen_tpu_torch.decoder.rescore import LmAutomaton, rescore_lattice
from eesen_tpu_torch.frontend.features import (
    FbankOptions, FrameOptions, MelOptions,
)
from eesen_tpu_torch.frontend.pipeline import FeaturePipelineConfig
from eesen_tpu_torch.models.model import AcousticModelConfig, check_device
from eesen_tpu_torch.ops import beam_cuda
from eesen_tpu_torch.recipes.augment import LIBRISPEECH_ROTATION, AugmentTag
from eesen_tpu_torch.recipes.config import RecipeConfig
from eesen_tpu_torch.recipes.lm import estimate_ngram_arpa
from eesen_tpu_torch.recipes.run import RecipeRun
from eesen_tpu_torch.recipes.synth_corpus import (
    SynthConfig, generate_corpus_from_texts, make_lexicon, make_phones,
    speaker_seed,
)
from eesen_tpu_torch.training.batching import BatchConfig
from eesen_tpu_torch.training.optim import OptimizerConfig
from eesen_tpu_torch.training.schedule import NewbobConfig
from eesen_tpu_torch.utils.stages import Stages

# the port's own name: a cache the JAX package wrote is never overwritten
BENCH_GRAPH_CACHE = os.path.join(
    tempfile.gettempdir(), "eesen_torch_bench_cache", "tlg_stress.npz")

VOCAB = 20000
HOMOPHONES = 400
OOV_WORDS = 200
CLASSES = 4
FANOUT = 40


# ---------------------------------------------------------------------
# text process: class-conditioned Markov chains over the vocabulary
# ---------------------------------------------------------------------

def build_text_process(n_words: int, rng: np.random.Generator):
    """successors[c][w] = FANOUT candidate next-words given previous word
    w and previous-previous CLASS c (w2 % CLASSES) — a genuinely
    second-order process, so a trigram LM beats a bigram."""
    succ = rng.integers(
        0, n_words, size=(CLASSES, n_words, FANOUT), dtype=np.int32
    )
    # Zipf weights over the successor slots (shared across contexts)
    w = (np.arange(1, FANOUT + 1, dtype=np.float64)) ** -1.1
    w /= w.sum()
    return succ, w


def sample_sentences(
    n_sents: int, succ, slot_p, n_words: int, rng: np.random.Generator,
    min_w: int = 4, max_w: int = 10,
) -> list:
    lens = rng.integers(min_w, max_w + 1, size=n_sents)
    slots = rng.choice(FANOUT, size=int(lens.sum()), p=slot_p)
    out = []
    pos = 0
    for n in lens:
        sent = np.empty(n, np.int32)
        prev = int(rng.integers(0, n_words))
        prev2 = int(rng.integers(0, n_words))
        for i in range(n):
            c = prev2 % CLASSES
            w = int(succ[c, prev, slots[pos]])
            pos += 1
            sent[i] = w
            prev2, prev = prev, w
        out.append(sent)
    return out


# ---------------------------------------------------------------------
# parallel synthesis (host cores; the workers never touch CUDA)
# ---------------------------------------------------------------------

_G = {}


def _synth_init(scfg, lexicon, phones_tbl, snr_range, speaker_seeds):
    _G["args"] = (scfg, lexicon, phones_tbl, snr_range, speaker_seeds)


def _synth_chunk(payload):
    seed, texts, utt2spk = payload
    scfg, lexicon, phones_tbl, snr_range, speaker_seeds = _G["args"]
    waves = generate_corpus_from_texts(
        scfg, texts, utt2spk, lexicon, phones_tbl,
        snr_range=snr_range, seed=seed, speaker_seeds=speaker_seeds,
    )
    return {k: v.astype(np.int16) for k, v in waves.items()}


def synth_parallel(scfg, texts, utt2spk, lexicon, phones_tbl, snr_range,
                   procs=2, chunk=400):
    """Waves of `texts`, `chunk` utterances a seeded task (seed 1000 + the
    chunk's first index), so the result does not depend on `procs`.  The
    pool is spawned, not forked: a fork of a process that has touched
    CUDA breaks, and the caller may have.  A spawned interpreter salts
    str hashes anew, so the speakers' seeds are taken here, once, from
    this process's hash (synth_corpus.speaker_seed, as the JAX script's
    forked workers inherit theirs): every chunk gets the same voices."""
    keys = sorted(texts)
    speaker_seeds = {s: speaker_seed(s) for s in set(utt2spk.values())}
    payloads = [
        (1000 + i, {k: texts[k] for k in keys[i:i + chunk]},
         {k: utt2spk[k] for k in keys[i:i + chunk]})
        for i in range(0, len(keys), chunk)
    ]
    waves = {}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(
        max(1, min(procs, len(payloads))), initializer=_synth_init,
        initargs=(scfg, lexicon, phones_tbl, snr_range, speaker_seeds),
    ) as pool:
        for i, part in enumerate(pool.imap_unordered(_synth_chunk,
                                                     payloads)):
            waves.update(part)
            if (i + 1) % 10 == 0:
                print(f"  synth {len(waves)}/{len(keys)} utts", flush=True)
    return waves


def merge_routes(graph, k: int):
    """Lanes of a search frame's emit and closure merges (K x the emit
    degree cap, K + K x the closure degree) and whether each fits the
    recombination kernel (ops/beam_cuda.MAX_LANES) or takes the sort
    route (decoder/beam.make_beam_decoder's rule)."""
    d_e = max(graph.max_emit_degree, 1)
    d_x = max(graph.max_closure_degree if graph.has_closure
              else graph.max_eps_degree, 1)
    lanes = {"emit": k * d_e, "closure": k + k * d_x}
    return {name: {"lanes": m, "padded": beam_cuda.padded_width(m),
                   "kernel": beam_cuda.padded_width(m)
                   <= beam_cuda.MAX_LANES}
            for name, m in lanes.items()}


def run_augment_ab(
    args, cfg, run_ctl, all_waves, tr_texts, tr_spk, cv_texts,
    ev_texts, ev_spk, labels, cv_f, ev_f, hist_ctl,
):
    """End-to-end augmentation A/B.

    run_ctl already holds the CONTROL model (stage C: canonical features
    only) and the LM-scale graph.  This trains a second model through
    the reference's 9-view VTLN x frame-rate rotation
    (run_nml_seq_fw_seq_tw.sh:92-150, train_ctc_parallel_mult.sh:205 via
    recipes/augment.py) and decodes BOTH models on (a) the matched
    canonical eval view and (b) a warp/rate-MISMATCHED eval view
    (frame shift 12 ms, VTLN warp 1.12 — outside both training sets but
    inside the augmentation span), recording the 2x2 WER table.
    Recommended scale: --utts 3000-6000 (9-view features are 9x the
    feature cost)."""

    class MemData:
        def __init__(self, waves, texts, utt2spk):
            self.wav_scp = waves
            self.text = texts
            self.utt2spk = utt2spk

    tr_waves = {k: all_waves[k].astype(np.float32) for k in tr_texts}
    d_tr = MemData(tr_waves, tr_texts, tr_spk)

    # 9-view features of the train set (canonical-view CMVN)
    t0 = time.time()
    aug_cache = os.path.join(args.workdir, "augfeats.npz")
    if os.path.exists(aug_cache):
        z = np.load(aug_cache, allow_pickle=True)
        tagged = {t: dict(z[t].item()) for t in z.files}
        print(f"aug features loaded from cache ({time.time()-t0:.0f}s)",
              flush=True)
    else:
        tagged = run_ctl.compute_augmented_features(d_tr)
        np.savez(aug_cache, **{t: np.array(fe, dtype=object)
                               for t, fe in tagged.items()})
        print(f"aug features (9 views x {len(tr_texts)} utts) in "
              f"{time.time()-t0:.0f}s", flush=True)

    # augmented model: fresh run dir, same lang/graph.  The multi-view
    # recipe passes --halving-after-epoch 386
    # (run_nml_seq_fw_seq_tw.sh:22,140): newbob's annealing/patience is
    # effectively disabled, because cv accuracy oscillates with the
    # epoch's training view and would otherwise fire spuriously
    # mid-rotation.  Train a fixed 2x rotation budget at constant LR.
    rotation = [t for t in LIBRISPEECH_ROTATION if t in tagged]
    aug_cfg = dataclasses.replace(
        cfg,
        newbob=dataclasses.replace(
            cfg.newbob,
            max_iters=2 * len(rotation),
            min_iters=2 * len(rotation),
            halving_after_epoch=10**6,
        ),
    )
    run_aug = RecipeRun(
        aug_cfg, os.path.join(args.workdir, "exp_aug"),
        run_ctl.lexicon, run_ctl.units, device=run_ctl.device,
    )
    run_aug.lang = run_ctl.lang
    run_aug.graph = run_ctl.graph
    canon = tagged.get("10_1") or next(iter(tagged.values()))
    t0 = time.time()
    hist_aug = run_aug.train(
        canon, {k: labels[k] for k in tr_texts},
        cv_f, {k: labels[k] for k in cv_texts},
        epochs_batches_repeat=args.epoch_repeat,
        tagged_feats=tagged,
        tag_order=rotation,
    )
    print(f"augmented train in {time.time()-t0:.0f}s", flush=True)
    for e in sorted(hist_aug):
        print(f"  epoch {e}: tag train {hist_aug[e]['train_acc']:.2f}% "
              f"cv {hist_aug[e]['cv_acc']:.2f}%", flush=True)

    # mismatched eval view: 12 ms shift + warp 1.12
    ev_waves = {k: all_waves[k].astype(np.float32) for k in ev_texts}
    d_ev = MemData(ev_waves, ev_texts, ev_spk)
    t0 = time.time()
    mis_tags = run_ctl.compute_augmented_features(
        d_ev, tags=[AugmentTag(12.0, 1.12)],
    )
    ev_mis = next(iter(mis_tags.values()))
    print(f"mismatched eval features in {time.time()-t0:.0f}s", flush=True)

    if args.aug_eval > 0:
        keep = set(sorted(ev_f)[:args.aug_eval])
        ev_f = {k: v for k, v in ev_f.items() if k in keep}
        ev_mis = {k: v for k, v in ev_mis.items() if k in keep}
    refs = {k: ev_texts[k] for k in ev_f}
    table = {}
    for mname, r in (("control", run_ctl), ("augmented", run_aug)):
        for vname, fe in (("matched", ev_f), ("mismatched", ev_mis)):
            t0 = time.time()
            stats, _ = r.decode(fe, refs)
            table[f"{mname}_{vname}"] = round(stats.wer, 2)
            print(f"  {mname} on {vname}: {stats.report()} "
                  f"({time.time()-t0:.0f}s)", flush=True)

    res = {
        "utts": args.utts,
        "rotation": [t for t in LIBRISPEECH_ROTATION if t in tagged],
        # a resumed-complete control run trains zero epochs -> {} history
        "control_final_cv_acc": (
            hist_ctl[max(hist_ctl)]["cv_acc"] if hist_ctl else None
        ),
        "augmented_final_cv_acc": (
            hist_aug[max(hist_aug)]["cv_acc"] if hist_aug else None
        ),
        "wer": table,
        "mismatch_view": "shift 12ms, vtln warp 1.12",
        "hard": bool(args.hard),
    }
    with open(os.path.join(args.workdir, "augment_results.json"), "w") as f:
        json.dump(res, f, indent=2)
    print("AUGMENT_RESULT", json.dumps(res), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "stress_recipe"))
    ap.add_argument("--utts", type=int, default=24000)
    ap.add_argument("--cv", type=int, default=150)
    ap.add_argument("--eval", type=int, default=300)
    ap.add_argument("--lm-sents", type=int, default=200000)
    ap.add_argument("--stage", type=int, default=0)
    ap.add_argument(
        "--hard", action="store_true",
        help="stress-v2 acoustics: confusable phone inventory, channel "
             "simulation, rate extremes, SNR 2-18 dB — drives the "
             "acoustic model itself below ~95%% token accuracy so the "
             "sweep/lattice/blank-skip parity battery runs under real "
             "AM uncertainty",
    )
    ap.add_argument(
        "--epoch-repeat", type=int, default=1,
        help="repeat the training batches N times per newbob epoch — "
             "REQUIRED for small --utts runs (a 4,000-utt --hard run at "
             "repeat=1 never leaves 0%% accuracy before newbob's "
             "patience runs out; the 24,000-utt run converges because "
             "each epoch simply has 6x the batches)",
    )
    ap.add_argument(
        "--aug-eval", type=int, default=0,
        help="with --augment: decode only the first N eval utts in the "
             "2x2 table (0 = all) — trims the 4-pass decode cost "
             "without touching the cached corpus",
    )
    ap.add_argument(
        "--stop-after", choices=["synth", "feats"], default=None,
        help="stop after the named stage (synth never touches CUDA) — "
             "the run resumes later from the caches in the workdir",
    )
    ap.add_argument(
        "--augment", action="store_true",
        help="A/B the 9-view VTLN x frame-rate augmentation rotation "
             "(recipes/augment.py) against a clean-trained control, "
             "scoring both on matched AND warp-mismatched eval features",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    t_all = time.time()
    stages = Stages()

    if args.hard:
        # stress-v2: overlapping phone classes (10 base templates x 4
        # variants), per-utterance channel tilt/band-limit, wider
        # speaking-rate spread, shorter phones, lower SNR
        scfg = SynthConfig(
            num_phones=40, num_words=VOCAB + OOV_WORDS, num_speakers=64,
            snr_db=15.0, seed=3, confusable_groups=10, channel_sim=True,
            rate_range=(0.7, 1.45), phone_dur_ms=(40, 110),
        )
        snr_range = (2.0, 18.0)
    else:
        scfg = SynthConfig(
            num_phones=40, num_words=VOCAB + OOV_WORDS, num_speakers=64,
            snr_db=15.0, seed=3,
        )
        snr_range = (8.0, 25.0)
    rng = np.random.default_rng(scfg.seed)
    phones_tbl = make_phones(scfg, rng)
    lex_path = os.path.join(args.workdir, "lexicon.pkl")
    if os.path.exists(lex_path):
        with open(lex_path, "rb") as f:
            synth_lexicon, decode_lexicon, oov_words = pickle.load(f)
    else:
        full = make_lexicon(scfg, rng)       # VOCAB + OOV unique prons
        # homophones: clone prons of 400 random words onto 400 others
        # (within the decode vocab)
        idx = rng.choice(VOCAB, size=2 * HOMOPHONES, replace=False)
        full = list(full)
        for a, b in zip(idx[:HOMOPHONES], idx[HOMOPHONES:]):
            full[b] = (full[b][0], full[a][1])
        synth_lexicon = full                      # all words synthesizable
        decode_lexicon = full[:VOCAB]             # OOV words NOT in lexicon
        oov_words = [w for w, _ in full[VOCAB:]]
        with open(lex_path, "wb") as f:
            pickle.dump((synth_lexicon, decode_lexicon, oov_words), f)
    word_list = [w for w, _ in decode_lexicon]
    print(f"lexicon: {len(decode_lexicon)} decode words "
          f"({HOMOPHONES} homophone pairs), {len(oov_words)} OOV synth "
          f"words", flush=True)

    # ---- texts ----
    succ, slot_p = build_text_process(VOCAB, np.random.default_rng(11))

    def to_words(sents):
        return [[word_list[int(j)] for j in s] for s in sents]

    trng = np.random.default_rng(12)
    tr_texts_l = to_words(sample_sentences(
        args.utts, succ, slot_p, VOCAB, trng))
    cv_texts_l = to_words(sample_sentences(
        args.cv, succ, slot_p, VOCAB, trng))
    ev_texts_l = to_words(sample_sentences(
        args.eval, succ, slot_p, VOCAB, trng))
    # OOV injection into eval: ~2.5% of tokens replaced by OOV words
    n_oov = 0
    for sent in ev_texts_l:
        for i in range(len(sent)):
            if trng.random() < 0.025:
                sent[i] = oov_words[int(trng.integers(0, len(oov_words)))]
                n_oov += 1
    total_ev = sum(len(s) for s in ev_texts_l)
    print(f"eval OOV tokens: {n_oov}/{total_ev} "
          f"({100.0 * n_oov / total_ev:.2f}%) -> WER floor "
          f"{100.0 * n_oov / total_ev:.2f}%", flush=True)

    def mk_utts(texts_l, prefix):
        texts, utt2spk = {}, {}
        for i, ws in enumerate(texts_l):
            spk = f"spk{i % scfg.num_speakers:03d}"
            utt = f"{spk}_{prefix}{i:06d}"
            texts[utt] = ws
            utt2spk[utt] = spk
        return texts, utt2spk

    tr_texts, tr_spk = mk_utts(tr_texts_l, "tr")
    cv_texts, cv_spk = mk_utts(cv_texts_l, "cv")
    ev_texts, ev_spk = mk_utts(ev_texts_l, "ev")

    # ---- stage A: synthesis (cached) ----
    wav_cache = os.path.join(args.workdir, "waves.npz")
    with stages("synth") as rec:
        if os.path.exists(wav_cache):
            z = np.load(wav_cache)
            all_waves = {k: z[k] for k in z.files}
            rec["cached"] = True
            print("waves loaded from cache", flush=True)
        else:
            all_texts = {**tr_texts, **cv_texts, **ev_texts}
            all_spk = {**tr_spk, **cv_spk, **ev_spk}
            all_waves = synth_parallel(
                scfg, all_texts, all_spk, synth_lexicon, phones_tbl,
                snr_range=snr_range, procs=min(os.cpu_count() or 2, 8),
            )
            np.savez(wav_cache, **all_waves)
            print(f"synthesized {len(all_waves)} utts", flush=True)
        rec["utts"] = len(all_waves)
    hours = sum(len(w) for w in all_waves.values()) / 16000 / 3600
    print(f"total audio: {hours:.2f} h", flush=True)
    if args.stop_after == "synth":
        print("stopping after synthesis (--stop-after)", flush=True)
        return {"stages": stages.rec, "hours": hours}

    # ---- recipe ----
    cfg = RecipeConfig(
        name="stress20k", dict_type="phn",
        fbank=FbankOptions(
            frame_opts=FrameOptions(dither=1.0),
            mel_opts=MelOptions(num_bins=40),
        ),
        pipeline=FeaturePipelineConfig(norm_vars=True, delta_order=2),
        model=AcousticModelConfig(
            input_dim=120, cell_dim=320, num_layers=4, num_targets=-1,
        ),
        optimizer=OptimizerConfig(algorithm="rmsprop", max_grad=50.0),
        newbob=NewbobConfig(learn_rate=5e-4, max_iters=10, min_iters=4),
        batch=BatchConfig(num_sequence=128, frame_limit=80000,
                          time_quant=128),
        decode=BeamSearchConfig(beam=17.0, max_active=512, funnel_mult=2,
                                acoustic_scale=0.9, lattice_beam=8.0,
                                blank_skip=0.98),
        blank_skip_guard=6,
    )
    units = [f"p{i:02d}" for i in range(scfg.num_phones)]
    lex_full = decode_lexicon + [("<UNK>", (units[0],))]
    run = RecipeRun(cfg, os.path.join(args.workdir, "exp"), lex_full, units,
                    device=device)
    with stages("lang"):
        run.build_lang()

    class MemData:
        def __init__(self, waves, texts, utt2spk):
            self.wav_scp = waves
            self.text = texts
            self.utt2spk = utt2spk

    # ---- stage B: features (cached) ----
    feat_cache = os.path.join(args.workdir, "feats.npz")
    with stages("features") as rec:
        if os.path.exists(feat_cache):
            z = np.load(feat_cache, allow_pickle=True)
            feats = {k: z[k] for k in z.files}
            rec["cached"] = True
            print("features loaded from cache", flush=True)
        else:
            all_texts = {**tr_texts, **cv_texts, **ev_texts}
            all_spk = {**tr_spk, **cv_spk, **ev_spk}
            d = MemData(
                {k: w.astype(np.float32) for k, w in all_waves.items()},
                all_texts, all_spk,
            )
            feats = run.compute_features(d)
            np.savez(feat_cache,
                     **{k: v.astype(np.float32) for k, v in feats.items()})
        rec["frames"] = int(sum(len(v) for v in feats.values()))
    if args.stop_after == "feats":
        print("stopping after features (--stop-after)", flush=True)
        return {"stages": stages.rec, "hours": hours}
    labels = run.prep_labels(MemData({}, {**tr_texts, **cv_texts}, {}))

    tr_f = {k: feats[k] for k in tr_texts}
    cv_f = {k: feats[k] for k in cv_texts}
    ev_f = {k: feats[k] for k in ev_texts}

    # ---- stage C: train (resumable from its checkpoints) ----
    with stages("train") as rec:
        hist = run.train(
            tr_f, {k: labels[k] for k in tr_texts},
            cv_f, {k: labels[k] for k in cv_texts},
            epochs_batches_repeat=args.epoch_repeat,
        )
        rec["epochs"] = len(hist)
    for e in sorted(hist):
        print(f"  epoch {e}: train {hist[e]['train_acc']:.2f}% "
              f"cv {hist[e]['cv_acc']:.2f}%", flush=True)

    # ---- stage D: trigram LM + LM-scale TLG (cached as npz) ----
    graph_cache = os.path.join(args.workdir, "tlg.npz")
    arpa_path = os.path.join(args.workdir, "lm.arpa.gz")
    if not os.path.exists(arpa_path):
        with stages("lm") as rec:
            lm_sents = to_words(sample_sentences(
                args.lm_sents, succ, slot_p, VOCAB,
                np.random.default_rng(13)))
            # pruned trigram (count >= 2 at orders 2-3), the reference's
            # "tgpr" shape (asr_egs/wsj run_ctc_phn.sh tgpr decode)
            arpa = estimate_ngram_arpa(
                lm_sents + list(tr_texts.values()), order=3,
                vocab=word_list, min_counts=(1, 2, 2),
            )
            rec["lines"] = len(arpa.splitlines())
            with gzip.open(arpa_path, "wt") as f:
                f.write(arpa)
    if os.path.exists(graph_cache):
        with stages("tlg") as rec:
            run.graph = CompiledGraph.load(graph_cache)
            rec["cached"] = True
    else:
        with gzip.open(arpa_path, "rt") as f:
            arpa = f.read()
        with stages("g") as rec:
            g = arpa_to_fst(arpa, run.lang.words)
            rec.update(states=g.num_states, arcs=g.num_arcs)
        with stages("tlg"):
            run.graph = build_full_compiled(
                run.lang.t_fst, run.lang.l_fst, g, build_closure=True,
            )
        run.graph.save(graph_cache)
    g = run.graph
    print(f"TLG: {g.num_states} states, "
          f"{g.num_emit_arcs + g.num_eps_arcs} arcs", flush=True)
    # the graph and pron rows for an LM-scale decode benchmark: posteriors
    # synthesized from these prons have token paths in this graph
    if not os.path.exists(BENCH_GRAPH_CACHE):
        os.makedirs(os.path.dirname(BENCH_GRAPH_CACHE), exist_ok=True)
        g.save(BENCH_GRAPH_CACHE)
        prng = np.random.default_rng(5)
        pick = prng.choice(len(decode_lexicon), size=512, replace=False)
        max_pron = max(len(p) for _, p in decode_lexicon)
        prons = np.full((512, max_pron), -1, np.int32)
        for r, i in enumerate(pick):
            for c, u in enumerate(decode_lexicon[int(i)][1]):
                prons[r, c] = run.lang.tokens[u]
        np.savez(BENCH_GRAPH_CACHE.replace(".npz", "_meta.npz"),
                 prons=prons, num_tokens=len(units))

    # the graph's tables on the device once, timed (each decode call
    # below puts its own copy, as recipes/run.run_search does)
    with stages("graph_put") as rec:
        dg = DeviceGraph.put(g, device=device)
        rec["bytes"] = int(sum(t.numel() * t.element_size() for t in dg))
    del dg

    if args.augment:
        return run_augment_ab(
            args, cfg, run, all_waves, tr_texts, tr_spk, cv_texts,
            ev_texts, ev_spk, labels, cv_f, ev_f, hist,
        )

    # ---- stage E: decode + parity evidence ----
    refs = {k: ev_texts[k] for k in ev_f}
    ev_frames = int(sum(len(v) for v in ev_f.values()))

    # E1: guarded sweep (decode once, rescale per acwt)
    with stages("sweep") as rec:
        sweep = run.score_sweep(ev_f, refs)
    sweep_s = rec["seconds"]
    guard_ok, guard = next(iter(run._guard_cache.values()), (None, {}))
    best_acwt, best = min(sweep.items(), key=lambda kv: kv[1].wer)
    for acwt in sorted(sweep):
        print(f"  acwt {acwt}: {sweep[acwt].report()}", flush=True)
    print(f"decode+sweep in {sweep_s:.0f}s; best acwt {best_acwt} "
          f"-> {best.wer:.2f}%", flush=True)

    # E2a: sweep == direct re-decode AT THE DECODE ACWT (the exact-parity
    # invariant: the lattice provably contains the best path of the
    # search it came from; at other acwts the sweep is a lattice
    # approximation, bounded by lattice_beam — same as the reference's
    # decode-once + lattice-scale scoring, local/score.sh:44-55).  The
    # direct searches are the sweep's own: where the guard rejected
    # blank-skip, the sweep searched every frame, and so do they (the
    # JAX script kept skipping there, comparing two different searches)
    dec_acwt = cfg.decode.acoustic_scale
    swept = cfg if guard_ok is not False else dataclasses.replace(
        cfg, decode=dataclasses.replace(cfg.decode, blank_skip=0.0))
    run.cfg = swept
    with stages("direct") as rec:
        direct, _ = run.decode(ev_f, refs, acoustic_scale=dec_acwt)
    rec["ms_per_frame"] = 1e3 * rec["seconds"] / ev_frames
    print(f"direct decode at decode acwt {dec_acwt}: {direct.report()}",
          flush=True)
    parity_sweep = abs(direct.wer - sweep[dec_acwt].wer) < 1e-9

    # E2b: the lattice-approximation gap at the swept best acwt — a
    # direct search at best_acwt may find paths the dec_acwt-pruned
    # lattice lost; record the gap (hard content exercises it)
    alt_acwt = best_acwt
    with stages("direct_best"):
        direct_alt, _ = run.decode(ev_f, refs, acoustic_scale=alt_acwt)
    run.cfg = cfg
    print(f"direct decode at best acwt {alt_acwt}: "
          f"{direct_alt.report()}", flush=True)

    # E3: blank-skip vs full decode on the whole eval set
    full_cfg = dataclasses.replace(cfg.decode, blank_skip=0.0)
    run.cfg = dataclasses.replace(cfg, decode=full_cfg)
    with stages("full_decode") as rec:
        full_stats, full_hyps = run.decode(ev_f, refs)
    rec["ms_per_frame"] = 1e3 * rec["seconds"] / ev_frames
    run.cfg = cfg
    with stages("skip_decode") as rec:
        skip_stats, skip_hyps = run.decode(ev_f, refs)
    rec["ms_per_frame"] = 1e3 * rec["seconds"] / ev_frames
    n_diff = sum(
        1 for k in full_hyps if full_hyps[k] != skip_hyps.get(k)
    )
    print(f"blank-skip parity: full {full_stats.wer:.2f}% vs skip "
          f"{skip_stats.wer:.2f}%; {n_diff}/{len(full_hyps)} utts differ",
          flush=True)

    # E4: const-arpa trie at LM scale — build/load time + memory, and
    # rescoring parity with the G-fst LmAutomaton on real lattices
    # (reference: src/lm/const-arpa-lm.h:32,202)
    with gzip.open(arpa_path, "rt") as f:
        arpa = f.read()
    with stages("const_arpa"):
        t0 = time.time()
        trie = ConstArpa.from_arpa(arpa, run.lang.words)
        build_s = time.time() - t0
        trie_path = os.path.join(args.workdir, "lm_const.npz")
        trie.save(trie_path)
        t0 = time.time()
        trie = ConstArpa.load(trie_path, mmap=True)
        load_s = time.time() - t0
        t0 = time.time()
        g_fst = arpa_to_fst(arpa, run.lang.words)
        auto = LmAutomaton(g_fst, backoff_ilabel=run.lang.words["#0"])
        gfst_s = time.time() - t0
    sample = sorted(ev_f)[:10]
    with stages("lattices"):
        lats = run.decode_lattices({k: ev_f[k] for k in sample})
    with stages("rescore"):
        n_match = 0
        t_trie = t_auto = 0.0
        for k in sample:
            lat = compact_to_lattice(lats[k].scaled(best_acwt))
            t0 = time.time()
            ra = rescore_lattice(lat, auto, lm_scale_new=0.5)
            t_auto += time.time() - t0
            t0 = time.time()
            rt = rescore_lattice(lat, trie, lm_scale_new=0.5)
            t_trie += time.time() - t0
            pa, pt = ra.best_path(), rt.best_path()
            if pa[1] == pt[1] and abs(pa[2] - pt[2]) < 1e-3:
                n_match += 1
    const_arpa_res = {
        "ngrams": trie.num_ngrams,
        "bytes": trie.bytes(),
        "build_s": round(build_s, 1),
        "mmap_load_s": round(load_s, 3),
        "gfst_automaton_s": round(gfst_s, 1),
        "rescore_parity": f"{n_match}/{len(sample)}",
        "rescore_s_per_utt_trie": round(t_trie / len(sample), 3),
        "rescore_s_per_utt_gfst": round(t_auto / len(sample), 3),
    }
    print("const-arpa:", json.dumps(const_arpa_res), flush=True)

    res = {
        "const_arpa": const_arpa_res,
        "corpus": {
            "hours": round(hours, 2), "vocab": VOCAB,
            "homophone_pairs": HOMOPHONES,
            "oov_tokens_pct": round(100.0 * n_oov / total_ev, 2),
            "speakers": scfg.num_speakers, "snr_db": list(snr_range),
            "hard": bool(args.hard),
            "train_utts": args.utts, "eval_utts": args.eval,
            "eval_frames": ev_frames,
        },
        "graph": {
            "states": g.num_states,
            "arcs": g.num_emit_arcs + g.num_eps_arcs,
            "lm_order": 3,
            "merges": merge_routes(g, cfg.decode.max_active),
        },
        # empty when training was resume-skipped (schedule complete)
        "final_cv_acc": (
            hist[max(hist)]["cv_acc"] if hist else None
        ),
        "sweep": {str(a): round(s.wer, 2) for a, s in sweep.items()},
        "best_acwt": best_acwt, "wer": best.wer,
        "wer_report": best.report(),
        "direct_decode_acwt": dec_acwt, "direct_wer": direct.wer,
        "direct_blank_skip": swept.decode.blank_skip,
        "sweep_equals_direct": bool(parity_sweep),
        "direct_at_best_acwt": {
            "acwt": alt_acwt, "wer": direct_alt.wer,
            "sweep_wer": sweep[alt_acwt].wer,
        },
        "blank_skip_guard": {
            "ok": guard_ok, "checked": len(guard.get("checked", ())),
            "mismatched": list(guard.get("mismatched", ())),
        },
        "blank_skip_wer": skip_stats.wer, "full_wer": full_stats.wer,
        "blank_skip_diff_utts": n_diff,
        "decode_sweep_s": round(sweep_s, 1),
        "total_s": round(time.time() - t_all, 1),
        "device": str(device),
        "stages": stages.rec,
    }
    with open(os.path.join(args.workdir, "results.json"), "w") as f:
        json.dump(res, f, indent=2)
    print("RESULT", json.dumps(res), flush=True)
    write_results_md(args.workdir, res, sweep)
    return res


def write_results_md(workdir, res, sweep):
    """Append/replace the stress-corpus section of results.md in the
    workdir (the v2 --hard run writes its own section so both records
    coexist)."""
    path = os.path.join(workdir, "results.md")
    hard = res["corpus"].get("hard")
    marker = "## Stress corpus v2" if hard else "## Stress corpus"
    head = ""
    if os.path.exists(path):
        with open(path) as f:
            head = f.read().split(marker)[0].rstrip() + "\n\n"
    c, g = res["corpus"], res["graph"]
    snr = c["snr_db"]
    hard_line = (
        " Stress-v2 acoustics: 10 confusable phone templates x 4 "
        "variants, per-utterance channel tilt/band-limit, speaking "
        "rates 0.7-1.45x." if hard else ""
    )
    lines = [
        marker + " (20k-word vocabulary, trigram LM, LM-scale TLG)",
        "",
        "The hard proxy for real-corpus validation "
        f"(eesen_tpu_torch/examples/stress_recipe.py on {res['device']}):",
        f"{c['hours']} h audio, {c['speakers']} speakers, per-utterance "
        f"SNR {snr[0]:g}-{snr[1]:g} dB, {c['vocab']}-word lexicon with "
        f"{c['homophone_pairs']} homophone pairs, {c['oov_tokens_pct']}% "
        "OOV tokens in eval (unrecognizable by construction — the WER "
        "floor), class-conditioned Markov text so the trigram LM has "
        "genuine predictive power." + hard_line,
        "",
        f"- TLG: **{g['states']:,} states / {g['arcs']:,} arcs** "
        "(order-3 LM, native one-call build)",
        f"- final cv token accuracy: {res['final_cv_acc']:.2f}%"
        if res["final_cv_acc"] is not None else
        "- final cv token accuracy: (training resumed complete)",
        "",
        "| acwt | WER |",
        "|---|---|",
    ]
    for acwt in sorted(sweep):
        mark = " **(best)**" if acwt == res["best_acwt"] else ""
        lines.append(f"| {acwt} | {sweep[acwt].wer:.2f}%{mark} |")
    lines += [
        "",
        f"Best: **{res['wer']:.2f}% WER** at acwt {res['best_acwt']} "
        f"({res['wer_report']}).",
        "",
        "Parity evidence on hard content:",
        f"- sweep (lattice rescale) == direct re-decode at the decode "
        f"acwt {res['direct_decode_acwt']}: "
        f"{'EXACT' if res['sweep_equals_direct'] else 'MISMATCH'} "
        f"({res['direct_wer']:.2f}%, blank-skip "
        f"{res['direct_blank_skip']:g})",
        f"- blank-skip guard on {res['blank_skip_guard']['checked']} "
        "sampled utterances: "
        + ("passed" if res["blank_skip_guard"]["ok"] else
           "failed, so the sweep and the direct searches searched every "
           "frame"),
        f"- lattice-approximation gap at the swept best acwt "
        f"{res['direct_at_best_acwt']['acwt']}: direct search "
        f"{res['direct_at_best_acwt']['wer']:.2f}% vs swept "
        f"{res['direct_at_best_acwt']['sweep_wer']:.2f}% (the sweep "
        "explores only paths the decode-acwt search kept — bounded by "
        "lattice_beam, same property as the reference's decode-once "
        "scoring)",
        f"- blank-skip {res['blank_skip_wer']:.2f}% vs full decode "
        f"{res['full_wer']:.2f}% WER; {res['blank_skip_diff_utts']} of "
        f"{c['eval_utts']} utterances differ",
    ]
    ca = res.get("const_arpa")
    if ca:
        lines += [
            f"- const-arpa trie at LM scale: {ca['ngrams']:,} ngrams, "
            f"{ca['bytes']/2**20:.0f} MiB, build {ca['build_s']}s, mmap "
            f"load {ca['mmap_load_s']}s (G-fst automaton build "
            f"{ca['gfst_automaton_s']}s); rescore best-path parity "
            f"{ca['rescore_parity']} at "
            f"{ca['rescore_s_per_utt_trie']}s/utt "
            f"(G-fst {ca['rescore_s_per_utt_gfst']}s/utt)",
        ]
    lines += [
        "",
        "Reproduce: `python -m eesen_tpu_torch.examples.stress_recipe "
        "WORKDIR`",
        "",
    ]
    with open(path, "w") as f:
        f.write(head + "\n".join(lines))
    print(f"wrote {path} stress section", flush=True)


if __name__ == "__main__":
    main()
