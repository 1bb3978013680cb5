"""Adversarial proposal rows for the recombination kernel (ops/beam_cuda.py,
csrc/dedup_prune.cu), shared by the CPU tests (tests/test_torch_dedup.py)
and the card tests (tests/test_torch_cuda.py).  Imports neither jax nor
torch."""

import numpy as np

CASES = ("random", "signed_zero", "negative", "ties", "all_dead", "one_dst",
         "few_live", "odd_dst", "nan")


def make_case(name: str, b: int, m: int, seed: int = 0):
    """dst [b, m] int32 and score [b, m] float32 for one named case:

    random       scores N(0, 4), 15% dead (+inf), dst in [0, m/3)
    signed_zero  scores among -0.0, +0.0 and +-1, so the key of -0.0 must
                 be the key of +0.0; many ties on a dst
    negative     all scores negative (graph weights can be), beam-cut
    ties         integer scores: score ties everywhere, broken by lane
    all_dead     every lane +inf
    one_dst      every lane on one dst
    few_live     a handful of live lanes, the rest dead
    odd_dst      dst values at the int32 extremes (INT_MIN is the table's
                 empty tag) and the padding's dst
    nan          odd rows all NaN; even rows one NaN among finite scores
                 (and some dead lanes): the row minimum is NaN, so is the
                 threshold, and the whole row comes out dead
    """
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, max(m // 3, 2), (b, m)).astype(np.int32)
    score = (rng.standard_normal((b, m)) * 4.0).astype(np.float32)
    if name == "random":
        score[rng.random((b, m)) < 0.15] = np.inf
    elif name == "signed_zero":
        score = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32),
                           (b, m))
        dst = rng.integers(0, max(m // 8, 2), (b, m)).astype(np.int32)
    elif name == "negative":
        score = (-50.0 - np.abs(score) * 3.0).astype(np.float32)
    elif name == "ties":
        score = np.round(score).astype(np.float32)
    elif name == "all_dead":
        score[:] = np.inf
    elif name == "one_dst":
        dst[:] = 7
    elif name == "few_live":
        score[rng.random((b, m)) < 0.97] = np.inf
    elif name == "odd_dst":
        pick = rng.choice(np.array([-2**31, 2**31 - 1, -1, 0x3FFFFFFF],
                                   np.int64), (b, m))
        dst = np.where(rng.random((b, m)) < 0.5, pick, dst).astype(np.int32)
    elif name == "nan":
        score[rng.random((b, m)) < 0.1] = np.inf
        score[1::2] = np.nan
        score[np.arange(0, b, 2), rng.integers(0, m, (b + 1) // 2)] = np.nan
    else:
        raise ValueError(name)
    return dst, score
