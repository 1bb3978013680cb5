"""The synthetic lexicon and the second-order text process of the
decode graph and the decode traffic.

Frozen copies of `make_lexicon` (eesen_tpu_torch/recipes/synth_corpus.py)
and of `build_text_process` / `sample_sentences`
(eesen_tpu_torch/examples/stress_recipe.py): the same draws from the same
numpy generators give the same words and sentences.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

CLASSES = 4
FANOUT = 40


def make_lexicon(num_words: int, num_phones: int, min_phones: int,
                 max_phones: int, rng: np.random.Generator
                 ) -> List[Tuple[str, Tuple[str, ...]]]:
    """`num_words` distinct prons of `min_phones`..`max_phones` units
    drawn uniformly from p00..p{num_phones-1}; words are w0000, w0001,
    ..."""
    units = [f"p{i:02d}" for i in range(num_phones)]
    seen = set()
    lex = []
    while len(lex) < num_words:
        n = int(rng.integers(min_phones, max_phones + 1))
        pron = tuple(units[int(j)] for j in rng.integers(0, num_phones, n))
        if pron in seen:
            continue
        seen.add(pron)
        lex.append((f"w{len(lex):04d}", pron))
    return lex


def build_text_process(n_words: int, rng: np.random.Generator):
    """successors[c][w] = FANOUT candidate next words given the previous
    word w and the class c = (word before it) % CLASSES, with Zipf
    weights over the successor slots: a second-order process, so that a
    trigram beats a bigram."""
    succ = rng.integers(
        0, n_words, size=(CLASSES, n_words, FANOUT), dtype=np.int32
    )
    w = (np.arange(1, FANOUT + 1, dtype=np.float64)) ** -1.1
    w /= w.sum()
    return succ, w


def sample_sentences(n_sents: int, succ, slot_p, n_words: int,
                     rng: np.random.Generator, min_w: int = 4,
                     max_w: int = 10) -> list:
    """`n_sents` word-id sentences of min_w..max_w words."""
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
