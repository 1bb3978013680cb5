"""Minimal n-gram LM estimation -> ARPA text.

The reference recipes shell out to external toolkits for LM training and
only consume the resulting ARPA file (e.g. asr_egs/wsj/run_ctc_phn.sh uses
the pre-built pruned trigram; swbd/local trains with srilm).  For
self-contained pipeline runs (and tests) this module provides an
absolute-discount interpolated bigram estimator producing a normalized
ARPA model that decoder/arpa.py can compile directly.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Tuple

import math

BOS, EOS = "<s>", "</s>"


def estimate_ngram_arpa(
    sentences: Iterable[List[str]],
    order: int = 3,
    discount: float = 0.5,
    vocab: List[str] | None = None,
    min_counts: Tuple[int, ...] | None = None,
) -> str:
    """Absolute-discounting Katz-backoff n-gram estimator -> ARPA text
    (any order; the reference consumes an external toolkit's trigram the
    same way, asr_egs/wsj/run_ctc_phn.sh tg).

    min_counts[k-1] is the count threshold for keeping order-k ngrams
    (1 = keep all); pruned mass flows into the backoff weight because
    bows are normalized against the KEPT set:
        bow(ctx) = (1 - sum_kept p(w|ctx)) / (1 - sum_kept p_lower(w|ctx'))
    which keeps every context exactly normalized under ARPA evaluation.
    Contexts of kept ngrams are force-kept so the ARPA file is closed
    under prefixes (required by arpa_to_fst and standard tools)."""
    if min_counts is None:
        min_counts = (1,) * order
    assert len(min_counts) == order

    counts: List[Counter] = [Counter() for _ in range(order)]
    for sent in sentences:
        toks = [BOS] + list(sent) + [EOS]
        for k in range(1, order + 1):
            for i in range(len(toks) - k + 1):
                if k == 1 and toks[i] == BOS:
                    continue
                counts[k - 1][tuple(toks[i : i + k])] += 1

    words = sorted(set(vocab or []) | {w for (w,) in counts[0]})
    if EOS in words:
        words.remove(EOS)
    total = sum(counts[0].values())
    v = len(words) + 1
    p_uni: Dict[Tuple[str, ...], float] = {}
    for w in words + [EOS]:
        p_uni[(w,)] = (counts[0].get((w,), 0) + 0.5) / (total + 0.5 * v)

    # context totals per order (computed from the FULL counts so pruned
    # ngrams' mass lands in the backoff)
    ctx_tot: List[Counter] = [Counter() for _ in range(order)]
    for k in range(2, order + 1):
        for ng, c in counts[k - 1].items():
            ctx_tot[k - 1][ng[:-1]] += c

    # kept sets (count-pruned, then closed under prefixes)
    kept: List[Dict[Tuple[str, ...], int]] = [dict(counts[0])]
    for k in range(2, order + 1):
        kept.append({
            ng: c for ng, c in counts[k - 1].items()
            if c >= min_counts[k - 1]
        })
    for k in range(order, 2, -1):
        for ng in kept[k - 1]:
            pfx = ng[:-1]
            if pfx not in kept[k - 2] and pfx in counts[k - 2]:
                kept[k - 2][pfx] = counts[k - 2][pfx]

    # stored probabilities, low order first (bows need lower-order evals)
    prob: Dict[Tuple[str, ...], float] = dict(p_uni)
    bow: Dict[Tuple[str, ...], float] = {}

    def p_eval(ng: Tuple[str, ...]) -> float:
        """ARPA evaluation: stored prob, else bow(ctx) * p(backoff)."""
        while True:
            if ng in prob:
                return prob[ng]
            if len(ng) == 1:
                return 1e-99
            b = bow.get(ng[:-1], 1.0)
            return b * p_eval(ng[1:])

    for k in range(2, order + 1):
        by_ctx: Dict[Tuple[str, ...], List[Tuple[Tuple[str, ...], int]]] = {}
        for ng, c in kept[k - 1].items():
            by_ctx.setdefault(ng[:-1], []).append((ng, c))
        for ctx, items in by_ctx.items():
            n = ctx_tot[k - 1][ctx]
            for ng, c in items:
                prob[ng] = max(c - discount, 1e-10) / n
        # bows for every context that has kept continuations (contexts
        # themselves are kept (k-1)-grams by prefix closure, or BOS-pads)
        for ctx, items in by_ctx.items():
            num = 1.0 - sum(prob[ng] for ng, _ in items)
            den = 1.0 - sum(p_eval(ng[1:]) for ng, _ in items)
            if den <= 1e-6:
                # every continuation is an explicit ngram: no mass can
                # flow through the backoff, so return the discounted
                # mass to the seen ngrams (SRILM does the same when the
                # bow denominator vanishes)
                scale = 1.0 / max(1.0 - num, 1e-10)
                for ng, _ in items:
                    prob[ng] *= scale
                bow[ctx] = 1e-10
            else:
                bow[ctx] = max(num, 1e-10) / den

    def log10(x: float) -> float:
        return math.log10(max(x, 1e-99))

    # contexts needing a bow line at order k-1: those with kept k-grams
    lines = ["\\data\\"]
    n_uni = len(words) + 2
    sizes = [n_uni] + [len(kept[k - 1]) for k in range(2, order + 1)]
    for k, sz in enumerate(sizes, 1):
        lines.append(f"ngram {k}={sz}")
    lines += ["", "\\1-grams:"]
    lines.append(f"-99\t{BOS}\t{log10(bow.get((BOS,), 1.0)):.6f}")
    lines.append(f"{log10(p_uni[(EOS,)]):.6f}\t{EOS}")
    for w in words:
        b = bow.get((w,), None)
        if b is None and order > 1:
            b = 1.0
        lines.append(
            f"{log10(p_uni[(w,)]):.6f}\t{w}\t{log10(b):.6f}"
            if b is not None else f"{log10(p_uni[(w,)]):.6f}\t{w}"
        )
    for k in range(2, order + 1):
        lines += ["", f"\\{k}-grams:"]
        last = k == order
        for ng in sorted(kept[k - 1]):
            p = log10(prob[ng])
            if last or ng not in bow:
                tail = ""
            else:
                tail = f"\t{log10(bow[ng]):.6f}"
            lines.append(f"{p:.6f}\t" + " ".join(ng).replace(" ", "\t")
                         + tail)
    lines += ["", "\\end\\", ""]
    return "\n".join(lines)
