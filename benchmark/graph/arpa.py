"""ARPA n-gram language model -> grammar FST G.

Reimplements the reference's G-building pipeline in one pass
(reference: src/decoderbin/arpa2fst.cc + the text filters applied in
asr_egs/wsj/local/wsj_decode_graph.sh:41-49:
  arpa2fst | fstprint | remove_oovs.pl | eps2disambig.pl | s2eps.pl |
  fstcompile | fstrmepsilon):

- states are n-gram histories; word arcs carry -ln(10^logprob)
- backoff arcs are labeled #0 on the input side (eps2disambig.pl) so LG
  stays determinizable, epsilon on the output side
- <s> becomes the start state, </s> becomes final weight (s2eps.pl drops
  both as symbols)
- n-grams containing OOV words (not in the word table) are dropped
  (remove_oovs.pl)
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.graph.fst import EPS, Arc, Fst, arcsort, connect
from benchmark.graph.ctc_graph import SymbolTable
import logging

log = logging.getLogger("benchmark.graph.arpa")

LN10 = math.log(10.0)


def parse_arpa(path_or_text: str) -> List[List[Tuple[float, Tuple[str, ...], float]]]:
    """Parse an ARPA file (path, .gz path, or raw text).

    Returns per-order lists of (log10prob, words, backoff_log10)."""
    if "\n" in path_or_text:
        lines = path_or_text.splitlines()
    elif path_or_text.endswith(".gz"):
        with gzip.open(path_or_text, "rt", errors="replace") as f:
            lines = f.read().splitlines()
    else:
        with open(path_or_text, errors="replace") as f:
            lines = f.read().splitlines()

    ngrams: List[List[Tuple[float, Tuple[str, ...], float]]] = []
    cur: Optional[int] = None
    in_data = False
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if line == "\\data\\":
            in_data = True
            continue
        if line.startswith("\\end\\"):
            break
        if line.startswith("\\") and line.endswith("-grams:"):
            cur = int(line[1:].split("-")[0]) - 1
            while len(ngrams) <= cur:
                ngrams.append([])
            continue
        if in_data and line.startswith("ngram "):
            continue
        if cur is None:
            continue
        parts = line.split()
        if len(parts) < cur + 2:
            continue
        logp = float(parts[0])
        words = tuple(parts[1 : cur + 2])
        backoff = float(parts[cur + 2]) if len(parts) > cur + 2 else None
        ngrams[cur].append((logp, words, backoff if backoff is not None else 0.0))
    return ngrams


def arpa_to_fst(
    path_or_text: str,
    words: Optional[SymbolTable] = None,
    disambig_symbol: str = "#0",
    bos: str = "<s>",
    eos: str = "</s>",
) -> Fst:
    """Build G from an ARPA LM.  `words` limits the vocabulary (OOV n-grams
    dropped); if None, a table is built from the LM itself."""
    ngrams = parse_arpa(path_or_text)
    order = len(ngrams)

    if words is None:
        # build the table from the LM's own unigram vocabulary
        # (arpa2fst.cc --write-symbol-table behavior)
        from benchmark.graph.ctc_graph import make_word_table
        words = make_word_table(
            w for _, (w,), _ in ngrams[0] if w not in (bos, eos)
        )

    vocab = {w for w, _ in words.items()}

    def in_vocab(ws: Tuple[str, ...]) -> bool:
        if vocab is None:
            return True
        return all(w in vocab or w in (bos, eos) for w in ws)

    # collect states: histories that either have continuations or backoffs
    fst = Fst()
    state_of: Dict[Tuple[str, ...], int] = {}

    def get_state(hist: Tuple[str, ...]) -> int:
        if hist not in state_of:
            state_of[hist] = fst.add_state()
        return state_of[hist]

    # histories that exist as prefix of an (n<order)-gram are states
    known_hist = {()}
    for n in range(order - 1):
        for _, ws, _ in ngrams[n]:
            if in_vocab(ws):
                known_hist.add(ws)

    def dest_hist(ws: Tuple[str, ...]) -> Tuple[str, ...]:
        """Longest suffix of ws that is a known history."""
        h = ws[-(order - 1):] if order > 1 else ()
        while h and h not in known_hist:
            h = h[1:]
        return h

    unigram = get_state(())
    dropped = 0
    backoff_id = None
    if words is not None and disambig_symbol in words:
        backoff_id = words[disambig_symbol]

    for n in range(order):
        for logp, ws, backoff in ngrams[n]:
            if not in_vocab(ws):
                dropped += 1
                continue
            hist, w = ws[:-1], ws[-1]
            if hist and hist not in known_hist:
                continue  # orphan n-gram (history itself OOV/dropped)
            weight = -logp * LN10
            if w == eos:
                s = get_state(hist)
                old = fst.finals.get(s)
                fst.set_final(s, weight if old is None else min(old, weight))
                continue
            if w == bos:
                # no word arc ever enters <s>; its state + backoff arc are
                # created by the history/backoff passes
                continue
            s = get_state(hist)
            d = get_state(dest_hist(ws))
            wid = words[w] if words is not None else 0
            if words is None:
                raise ValueError("arpa_to_fst requires a word table")
            fst.add_arc(s, Arc(wid, wid, weight, d))

    # backoff arcs
    for n in range(order - 1):
        for logp, ws, backoff in ngrams[n]:
            if not in_vocab(ws) or ws not in known_hist:
                continue
            if ws == (bos,):
                lower = ()
            else:
                lower = dest_hist(ws[1:]) if len(ws) > 1 else ()
            s = state_of.get(ws)
            if s is None:
                continue
            bw = -backoff * LN10
            il = backoff_id if backoff_id is not None else EPS
            fst.add_arc(s, Arc(il, EPS, bw, get_state(lower)))

    start_hist = (bos,) if (bos,) in state_of else ()
    fst.set_start(state_of[start_hist])
    if dropped:
        log.info("arpa_to_fst: dropped %d OOV n-grams", dropped)
    return arcsort(connect(fst), "ilabel")
