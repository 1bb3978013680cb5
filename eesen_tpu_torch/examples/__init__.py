"""End-to-end recipe examples (counterparts of the JAX package's
examples/): each runs as

    python -m eesen_tpu_torch.examples.<name> [workdir] [args] [--device D]

  toy_recipe     the tone corpus through lang, features, newbob training,
                 TLG, beam decode and WER (a minute on the card);
  synth_recipe   the flagship: 2,500 formant-synthesis utterances, 500
                 words, 4 x 320 BiLSTM, bigram LM, decode-once acwt sweep;
  stress_recipe  the 20,000-word trigram LM-scale run with its parity
                 battery (sweep against direct re-decode, blank-skip
                 against the full decode, const-arpa rescoring).

`--device` is "cuda" by default; without a card the scripts raise unless
given `--device cpu`.  Nothing is built or imported from here at package
import: each script is a module of its own.
"""
