"""Flagship end-to-end run on the synthetic formant corpus (counterpart
of the JAX package's examples/synth_recipe.py).

The closest available stand-in for a real-corpus recipe (no LDC/OpenSLR
data can ship with this repo): 500-word vocabulary, 20 speakers, Zipf
word distribution, ~1 h of training audio — through the FULL pipeline:
wav -> fbank+CMVN+deltas -> 4x320 BiLSTM-CTC (the WSJ flagship config)
-> bigram LM estimated from the training text -> TLG -> batched beam
decode ONCE -> acwt sweep by lattice rescaling -> WER -> results.md in
the workdir.

Usage: python -m eesen_tpu_torch.examples.synth_recipe [workdir]
           [--utts N] [--cv N] [--eval N] [--epochs-repeat N]
           [--device cuda|cpu]
"""

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np

from eesen_tpu_torch.decoder.beam import BeamSearchConfig
from eesen_tpu_torch.frontend.features import (
    FbankOptions, FrameOptions, MelOptions,
)
from eesen_tpu_torch.frontend.pipeline import FeaturePipelineConfig
from eesen_tpu_torch.models.model import AcousticModelConfig, check_device
from eesen_tpu_torch.recipes.config import RecipeConfig
from eesen_tpu_torch.recipes.lm import estimate_bigram_arpa
from eesen_tpu_torch.recipes.run import RecipeRun
from eesen_tpu_torch.recipes.synth_corpus import (
    SynthConfig, generate_corpus, make_lexicon, make_phones,
)
from eesen_tpu_torch.training.batching import BatchConfig
from eesen_tpu_torch.training.optim import OptimizerConfig
from eesen_tpu_torch.training.schedule import NewbobConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "synth_recipe"))
    ap.add_argument("--utts", type=int, default=2500)
    ap.add_argument("--cv", type=int, default=64)
    ap.add_argument("--eval", type=int, default=100)
    # repeats per newbob epoch: ~2h of synthetic audio needs a few passes
    # per epoch so CTC breaks out of all-blank before the schedule starts
    # halving (the reference's corpora are 80-300h, so one pass per epoch
    # suffices there).  rmsprop lr=5e-4 escapes within one 2-pass epoch;
    # adagrad 0.02-0.05 needs 4-5 epochs; adagrad 0.12 diverges.
    ap.add_argument("--epochs-repeat", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)

    t_all = time.time()
    scfg = SynthConfig()
    rng = np.random.default_rng(scfg.seed)
    phones_tbl = make_phones(scfg, rng)
    lexicon = make_lexicon(scfg, rng)
    units = [f"p{i:02d}" for i in range(scfg.num_phones)]

    t0 = time.time()
    tr_waves, tr_texts, tr_spk = generate_corpus(
        scfg, args.utts, split_seed=1, lexicon=lexicon, phones_tbl=phones_tbl)
    cv_waves, cv_texts, cv_spk = generate_corpus(
        scfg, args.cv, split_seed=2, lexicon=lexicon, phones_tbl=phones_tbl)
    ev_waves, ev_texts, ev_spk = generate_corpus(
        scfg, args.eval, split_seed=3, lexicon=lexicon, phones_tbl=phones_tbl)
    hours = sum(len(w) for w in tr_waves.values()) / 16000 / 3600
    print(f"synthesized {args.utts} train utts ({hours:.2f} h) "
          f"in {time.time()-t0:.0f}s", flush=True)

    cfg = RecipeConfig(
        name="synth500", dict_type="phn",
        fbank=FbankOptions(
            frame_opts=FrameOptions(dither=1.0),
            mel_opts=MelOptions(num_bins=40),
        ),
        pipeline=FeaturePipelineConfig(norm_vars=True, delta_order=2),
        model=AcousticModelConfig(
            input_dim=120, cell_dim=320, num_layers=4, num_targets=-1,
        ),
        optimizer=OptimizerConfig(algorithm="rmsprop", max_grad=50.0),
        newbob=NewbobConfig(learn_rate=5e-4, max_iters=12, min_iters=6),
        batch=BatchConfig(num_sequence=16, frame_limit=25000, time_quant=256),
        decode=BeamSearchConfig(beam=17.0, max_active=512, funnel_mult=2,
                                acoustic_scale=0.9, lattice_beam=8.0,
                                blank_skip=0.98),
    )
    lex_full = lexicon + [("<UNK>", (units[0],))]
    run = RecipeRun(cfg, os.path.join(args.workdir, "exp"), lex_full, units,
                    device=device)
    run.build_lang()

    # features straight from in-memory waves via a DataDir-like shim
    class MemData:
        def __init__(self, waves, texts, utt2spk):
            self.wav_scp = {k: w for k, w in waves.items()}
            self.text = texts
            self.utt2spk = utt2spk

    def feats_for(waves, texts, spk):
        d = MemData(waves, texts, spk)
        return run.compute_features(d), run.prep_labels(d)

    t0 = time.time()
    feat_cache = os.path.join(args.workdir, "feats.npz")
    if os.path.exists(feat_cache):
        z = np.load(feat_cache, allow_pickle=True)
        tr_f, tr_l, cv_f, cv_l, ev_f = (
            z[k].item() for k in ("tr_f", "tr_l", "cv_f", "cv_l", "ev_f")
        )
        print("features loaded from cache", flush=True)
    else:
        tr_f, tr_l = feats_for(tr_waves, tr_texts, tr_spk)
        cv_f, cv_l = feats_for(cv_waves, cv_texts, cv_spk)
        ev_f, _ = feats_for(ev_waves, ev_texts, ev_spk)
        np.savez(feat_cache, tr_f=tr_f, tr_l=tr_l, cv_f=cv_f, cv_l=cv_l,
                 ev_f=ev_f)
        print(f"features in {time.time()-t0:.0f}s", flush=True)

    t0 = time.time()
    hist = run.train(tr_f, tr_l, cv_f, cv_l,
                     epochs_batches_repeat=args.epochs_repeat)
    print(f"train in {time.time()-t0:.0f}s", flush=True)
    for e in sorted(hist):
        print(f"  epoch {e}: train {hist[e]['train_acc']:.2f}% "
              f"cv {hist[e]['cv_acc']:.2f}%", flush=True)

    # LM from TRAINING transcripts only (real-recipe style)
    arpa = estimate_bigram_arpa(list(tr_texts.values()),
                                vocab=[w for w, _ in lexicon])
    t0 = time.time()
    run.build_graph(arpa)
    print(f"graph in {time.time()-t0:.0f}s: {run.graph.num_states} states, "
          f"{run.graph.num_emit_arcs + run.graph.num_eps_arcs} arcs",
          flush=True)

    refs = {k: ev_texts[k] for k in ev_f}
    t0 = time.time()
    sweep = run.score_sweep(ev_f, refs)
    dt = time.time() - t0
    best_acwt, best = min(sweep.items(), key=lambda kv: kv[1].wer)
    print(f"decode+sweep in {dt:.0f}s", flush=True)
    for acwt in sorted(sweep):
        print(f"  acwt {acwt}: {sweep[acwt].report()}", flush=True)
    eval_audio_s = sum(len(w) for w in ev_waves.values()) / 16000

    res = {
        "corpus": dataclasses.asdict(scfg),
        "train_utts": args.utts, "train_hours": round(hours, 2),
        "eval_utts": args.eval,
        "final_cv_acc": hist[max(hist)]["cv_acc"],
        "best_acwt": best_acwt,
        "wer": best.wer,
        "wer_report": best.report(),
        "decode_sweep_s": round(dt, 1),
        "eval_audio_s": round(eval_audio_s, 1),
        "total_s": round(time.time() - t_all, 1),
        "device": str(device),
    }
    with open(os.path.join(args.workdir, "results.json"), "w") as f:
        json.dump(res, f, indent=2)
    print("RESULT", json.dumps(res), flush=True)
    write_results_md(args.workdir, res, sweep, hist)
    return res


def write_results_md(workdir, res, sweep, hist):
    """results.md in the workdir: the per-recipe RESULTS file the
    reference publishes (e.g. asr_egs/wsj/RESULTS), for the one corpus
    that can ship with this repo."""
    lines = [
        "# RESULTS — synthetic formant corpus (flagship end-to-end run)",
        "",
        "`recipes/synth_corpus.py`: a formant-synthesis corpus with a Zipf",
        "word distribution, through the full pipeline the reference runs",
        "on WSJ (asr_egs/wsj/run_ctc_phn.sh): wav -> fbank+CMVN+deltas ->",
        "4x320 BiLSTM-CTC -> bigram LM from training text -> TLG -> batched",
        f"beam decode once on {res['device']} -> acwt sweep by lattice",
        "rescaling -> WER.",
        "",
        f"- train: {res['train_utts']} utts ({res['train_hours']} h), "
        f"eval: {res['eval_utts']} utts ({res['eval_audio_s']} audio-s)",
        f"- final cv token accuracy: {res['final_cv_acc']:.2f}%",
        f"- decode+sweep wall time: {res['decode_sweep_s']} s "
        "(decode once, rescale lattices per acwt)",
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
        "Reproduce: `python -m eesen_tpu_torch.examples.synth_recipe "
        "WORKDIR`",
        "",
    ]
    path = os.path.join(workdir, "results.md")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
