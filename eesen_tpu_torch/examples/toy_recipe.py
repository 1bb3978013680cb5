"""End-to-end example: train and decode a toy corpus with the recipe API
(counterpart of the JAX package's examples/toy_recipe.py).

Synthesizes a tone-"phoneme" corpus (each phone is a sine frequency),
then runs the complete pipeline the way a real corpus recipe would
(reference equivalent: asr_egs/wsj/run_ctc_phn.sh):

  lang build -> features (fbank + per-speaker CMVN + deltas)
  -> CTC training with the newbob schedule -> TLG graph
  -> batched beam decoding -> WER.

Run:  python -m eesen_tpu_torch.examples.toy_recipe [workdir] [--device D]

On the card ("cuda", the default) training runs the LSTM and CTC kernels
and the decode the LSTM and recombination kernels; `--device cpu` runs
their plain PyTorch versions.  Without a card and without `--device cpu`
it raises.
"""

import argparse
import os
import struct
import tempfile

import numpy as np

from eesen_tpu_torch.decoder.beam import BeamSearchConfig
from eesen_tpu_torch.frontend.features import (
    FbankOptions, FrameOptions, MelOptions,
)
from eesen_tpu_torch.frontend.pipeline import FeaturePipelineConfig
from eesen_tpu_torch.io.datadir import DataDir
from eesen_tpu_torch.models.model import AcousticModelConfig, check_device
from eesen_tpu_torch.recipes.config import RecipeConfig
from eesen_tpu_torch.recipes.run import RecipeRun
from eesen_tpu_torch.training.batching import BatchConfig
from eesen_tpu_torch.training.optim import OptimizerConfig
from eesen_tpu_torch.training.schedule import NewbobConfig

SR = 16000
PHONES = ["aa", "bb", "cc", "dd"]
FREQ = {p: 400 + 350 * i for i, p in enumerate(PHONES)}
WORDS = {
    "apple": ("aa", "bb"),
    "cider": ("cc", "dd"),
    "bad": ("bb", "aa", "dd"),
    "cab": ("cc", "aa", "bb"),
}
ARPA = """
\\data\\
ngram 1=6

\\1-grams:
-0.5 </s>
-99 <s>
-0.7 apple
-0.7 cider
-0.7 bad
-0.7 cab

\\end\\
"""
# training batches repeated per newbob epoch
EPOCH_REPEAT = 40


def write_wav(path, samples):
    body = samples.astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(
            b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, SR, SR * 2, 2, 16)
            + b"data" + struct.pack("<I", len(body)) + body
        )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="eesen_tpu_toy_")
    print(f"workdir: {work}")
    rng = np.random.default_rng(0)

    # ---- synthesize a corpus as wav files + a Kaldi data dir ----
    vocab = list(WORDS)
    wav_dir = os.path.join(work, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    wav_scp, text, utt2spk = {}, {}, {}
    for i in range(32):
        n = int(rng.integers(1, 4))
        ws = [vocab[int(j)] for j in rng.integers(0, len(vocab), n)]
        segs = []
        for w in ws:
            for p in WORDS[w]:
                dur = int(rng.integers(1500, 2200))
                t = np.arange(dur) / SR
                segs.append(np.sin(2 * np.pi * FREQ[p] * t) * 8000)
        x = np.concatenate(segs)
        x = x + rng.standard_normal(len(x)) * 80
        utt = f"utt{i:03d}"
        path = os.path.join(wav_dir, f"{utt}.wav")
        write_wav(path, x)
        wav_scp[utt], text[utt], utt2spk[utt] = path, ws, f"spk{i % 4}"
    data = DataDir.write(
        os.path.join(work, "data"), wav_scp=wav_scp, text=text,
        utt2spk=utt2spk,
    )
    data.validate()

    # ---- recipe config (a miniature wsj_phn) ----
    cfg = RecipeConfig(
        name="toy", dict_type="phn",
        fbank=FbankOptions(
            frame_opts=FrameOptions(dither=0.0),
            mel_opts=MelOptions(num_bins=20),
        ),
        pipeline=FeaturePipelineConfig(norm_vars=True, delta_order=2),
        model=AcousticModelConfig(
            input_dim=60, cell_dim=48, num_layers=2, num_targets=-1,
        ),
        optimizer=OptimizerConfig(algorithm="adagrad", max_grad=50.0),
        newbob=NewbobConfig(learn_rate=0.05, max_iters=8, min_iters=5),
        batch=BatchConfig(num_sequence=8, frame_limit=20000, time_quant=128),
        decode=BeamSearchConfig(beam=20.0, max_active=512,
                                acoustic_scale=0.9),
    )
    lexicon = [(w, p) for w, p in WORDS.items()] + [("<UNK>", ("aa",))]
    run = RecipeRun(cfg, os.path.join(work, "exp"), lexicon, PHONES,
                    device=device)

    run.build_lang()
    labels = run.prep_labels(data)
    feats = run.compute_features(data)
    keys = sorted(feats)
    tr, cv = keys[:24], keys[24:]

    def repeat_feats(keyset, times):
        return {k: feats[k] for k in keyset}, {k: labels[k] for k in keyset}

    tr_f, tr_l = repeat_feats(tr, 1)
    cv_f, cv_l = repeat_feats(cv, 1)
    hist = run.train(tr_f, tr_l, cv_f, cv_l,
                     epochs_batches_repeat=EPOCH_REPEAT)
    for e in sorted(hist):
        print(
            f"epoch {e}: train {hist[e]['train_acc']:.1f}% "
            f"cv {hist[e]['cv_acc']:.1f}%"
        )

    run.build_graph(ARPA)
    refs = {k: text[k] for k in cv}
    stats, hyps = run.decode(cv_f, refs)
    print("DECODE:", stats.report())
    for k in sorted(hyps)[:4]:
        print(f"  {k}: ref={' '.join(refs[k])}  hyp={' '.join(hyps[k])}")
    return {"history": hist, "stats": stats, "hyps": hyps, "refs": refs}


if __name__ == "__main__":
    main()
