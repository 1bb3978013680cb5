"""CTC decoding-graph construction: T, L, and TLG = T o min(det(L o G)).

Reimplements the reference's graph-build recipe:
- token FST T (blank loops, per-label repeat-collapsing self-loops,
  disambig passthrough): asr_egs/wsj/utils/ctc_token_fst.py:9-28
- lexicon disambiguation: utils/add_lex_disambig.pl
- lexicon FST L (with optional silence/space insertion):
  utils/make_lexicon_fst.pl
- tokens.txt / words.txt symbol tables + disambig self-loops on L:
  utils/ctc_compile_dict_token.sh:56-98
- TLG composition: local/wsj_decode_graph.sh:53-55
  (LG = fstdeterminizestar --use-log(fsttablecompose L G) |
   fstminimizeencoded;  TLG = fsttablecompose T LG)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.graph.fst import EPS, Arc, Fst, add_self_loops, arcsort


class SymbolTable:
    """String <-> id table (tokens.txt / words.txt)."""

    def __init__(self) -> None:
        self._s2i: Dict[str, int] = {}
        self._i2s: List[str] = []

    def add(self, sym: str) -> int:
        if sym in self._s2i:
            return self._s2i[sym]
        i = len(self._i2s)
        self._s2i[sym] = i
        self._i2s.append(sym)
        return i

    def __getitem__(self, sym: str) -> int:
        return self._s2i[sym]

    def __contains__(self, sym: str) -> bool:
        return sym in self._s2i

    def __len__(self) -> int:
        return len(self._i2s)

    def items(self):
        return ((s, i) for i, s in enumerate(self._i2s))


# --------------------------------------------------------------------------
# lexicon disambiguation (utils/add_lex_disambig.pl)
# --------------------------------------------------------------------------

def add_lex_disambig(
    lexicon: Sequence[Tuple[str, float, Tuple[str, ...]]]
) -> Tuple[List[Tuple[str, float, Tuple[str, ...]]], int]:
    """Append #1, #2, ... to pronunciations that are duplicates or
    prefixes of others.  Returns (disambiguated lexicon, max disambig index
    used)."""
    counts: Dict[Tuple[str, ...], int] = {}
    for _, _, phones in lexicon:
        counts[phones] = counts.get(phones, 0) + 1
    is_prefix: Dict[Tuple[str, ...], bool] = {}
    for _, _, phones in lexicon:
        p = list(phones)
        while p:
            p.pop()
            is_prefix[tuple(p)] = True
    out = []
    last_used: Dict[Tuple[str, ...], int] = {}
    max_disambig = 0
    first_allowed = 1
    for word, prob, phones in lexicon:
        if counts[phones] == 1 and not is_prefix.get(phones, False):
            out.append((word, prob, phones))
        else:
            cur = last_used.get(phones, first_allowed - 1) + 1
            last_used[phones] = cur
            max_disambig = max(max_disambig, cur)
            out.append((word, prob, phones + (f"#{cur}",)))
    return out, max_disambig


# --------------------------------------------------------------------------
# symbol tables (ctc_compile_dict_token.sh:56-75)
# --------------------------------------------------------------------------

def make_token_table(units: Sequence[str], ndisambig: int) -> SymbolTable:
    """tokens.txt: <eps>, <blk>, units..., #0..#ndisambig."""
    t = SymbolTable()
    t.add("<eps>")
    t.add("<blk>")
    for u in units:
        t.add(u)
    for n in range(ndisambig + 1):
        t.add(f"#{n}")
    return t


def make_word_table(words: Sequence[str]) -> SymbolTable:
    """words.txt: <eps> 0, sorted unique words, #0 last."""
    t = SymbolTable()
    t.add("<eps>")
    for w in sorted(set(words)):
        t.add(w)
    t.add("#0")
    return t


# --------------------------------------------------------------------------
# token FST T (utils/ctc_token_fst.py)
# --------------------------------------------------------------------------

def token_fst(tokens: SymbolTable) -> Fst:
    """Blank loops + per-label self-loops collapsing repeats + disambig
    passthrough at the start/final state."""
    f = Fst()
    s0 = f.add_state()  # start & final; disambig passthrough
    s1 = f.add_state()  # pre/inter-label blank loop
    s2 = f.add_state()  # post-label blank loop
    f.set_start(s0)
    f.set_final(s0, 0.0)
    blk = tokens["<blk>"]
    f.add_arc(s0, Arc(EPS, EPS, 0.0, s1))
    f.add_arc(s1, Arc(blk, EPS, 0.0, s1))
    f.add_arc(s2, Arc(blk, EPS, 0.0, s2))
    f.add_arc(s2, Arc(EPS, EPS, 0.0, s0))
    for sym, idx in tokens.items():
        if sym in ("<eps>", "<blk>"):
            continue
        if sym.startswith("#"):
            f.add_arc(s0, Arc(EPS, idx, 0.0, s0))
        else:
            ns = f.add_state()
            f.add_arc(s1, Arc(idx, idx, 0.0, ns))
            f.add_arc(ns, Arc(idx, EPS, 0.0, ns))   # repeats collapse
            f.add_arc(ns, Arc(EPS, EPS, 0.0, s2))
    return arcsort(f, "olabel")


# --------------------------------------------------------------------------
# lexicon FST L (utils/make_lexicon_fst.pl)
# --------------------------------------------------------------------------

def lexicon_fst(
    lexicon: Sequence[Tuple[str, float, Tuple[str, ...]]],
    tokens: SymbolTable,
    words: SymbolTable,
    sil_prob: float = 0.0,
    sil_phone: str = "sil",
    sil_disambig: Optional[str] = None,
) -> Fst:
    """Phones->words transducer with optional inter-word silence.

    With sil_prob == 0 this is the phn recipe's branch (single loop state);
    with sil_prob > 0 the char recipe's branch (e.g. 0.5 with a space
    "phone") — make_lexicon_fst.pl:73-160.  Adds the reference's
    #0:#0 self-loops (fstaddselfloops) and olabel-sorts."""
    f = Fst()
    if sil_prob == 0.0:
        loop = f.add_state()
        f.set_start(loop)
        f.set_final(loop, 0.0)
        start_states = [(loop, 0.0)]
        end_state = loop
        _add_lexicon_paths(f, lexicon, tokens, words, loop, loop)
    else:
        assert sil_prob < 1.0
        sil_cost = -math.log(sil_prob)
        no_sil_cost = -math.log(1.0 - sil_prob)
        start = f.add_state()
        loop = f.add_state()
        sil = f.add_state()
        f.set_start(start)
        f.set_final(loop, 0.0)
        f.add_arc(start, Arc(EPS, EPS, no_sil_cost, loop))
        silphone_id = tokens[sil_phone]
        if sil_disambig is None:
            f.add_arc(start, Arc(silphone_id, EPS, sil_cost, loop))
            f.add_arc(sil, Arc(silphone_id, EPS, 0.0, loop))
        else:
            disambig_state = f.add_state()
            dis_id = tokens[sil_disambig]
            f.add_arc(start, Arc(silphone_id, EPS, sil_cost, disambig_state))
            f.add_arc(sil, Arc(silphone_id, EPS, 0.0, disambig_state))
            f.add_arc(disambig_state, Arc(dis_id, EPS, 0.0, loop))
        _add_lexicon_paths(
            f, lexicon, tokens, words, loop, None,
            sil_state=sil, sil_cost=sil_cost, no_sil_cost=no_sil_cost,
        )
    # fstaddselfloops: pass the LM backoff disambig #0 through L
    l = add_self_loops(f, [tokens["#0"]], [words["#0"]])
    return arcsort(l, "olabel")


def _add_lexicon_paths(
    f: Fst, lexicon, tokens: SymbolTable, words: SymbolTable,
    loop: int, end: Optional[int],
    sil_state: Optional[int] = None,
    sil_cost: float = 0.0, no_sil_cost: float = 0.0,
) -> None:
    for word, prob, phones in lexicon:
        pron_cost = -math.log(prob) if prob not in (0.0, 1.0) else 0.0
        cur = loop
        out = words[word]
        for k, p in enumerate(phones):
            last = k == len(phones) - 1
            il = tokens[p]
            ol = out if k == 0 else EPS
            w = pron_cost if k == 0 else 0.0
            if not last:
                nxt = f.add_state()
                f.add_arc(cur, Arc(il, ol, w, nxt))
                cur = nxt
            elif sil_state is None:
                f.add_arc(cur, Arc(il, ol, w, loop))
            else:
                # final phone: branch to loop (no sil) and sil state
                f.add_arc(cur, Arc(il, ol, w + no_sil_cost, loop))
                f.add_arc(cur, Arc(il, ol, w + sil_cost, sil_state))


# --------------------------------------------------------------------------
# TLG assembly (local/wsj_decode_graph.sh:53-55)
# --------------------------------------------------------------------------

def build_full_compiled(
    t_fst: Fst, l_fst: Fst, g_fst: Fst,
    max_degree: int = 16, hub_threshold: int = 0,
    build_closure: bool = True,
):
    """The full TLG build (LG = min(det_log(L o G)), then T o LG
    compiled to device tables) in one native call, where no
    multi-million-arc intermediate crosses the Python boundary."""
    from benchmark.graph import fst_native as fnat

    return fnat.build_full_compiled(
        t_fst, l_fst, g_fst, max_degree, hub_threshold, build_closure
    )


@dataclasses.dataclass
class Lang:
    """A compiled language directory: symbol tables + graphs."""
    tokens: SymbolTable
    words: SymbolTable
    t_fst: Fst
    l_fst: Fst
    ndisambig: int


def compile_lang(
    lexicon: Sequence[Tuple[str, Tuple[str, ...]]],
    units: Sequence[str],
    dict_type: str = "phn",
    space_char: str = "<SPACE>",
) -> Lang:
    """ctc_compile_dict_token.sh: tokens/words/T/L from a plain lexicon
    [(word, phones...)], pron-probs fixed at 1.0 as in the recipe."""
    lex_p = [(w, 1.0, tuple(p)) for w, p in lexicon]
    lex_dis, max_dis = add_lex_disambig(lex_p)
    ndisambig = max_dis + 1  # recipe: ndisambig+1 (sil disambig reserve)
    tokens = make_token_table(units, ndisambig)
    words = make_word_table([w for w, _, _ in lex_dis])
    t = token_fst(tokens)
    if dict_type == "phn":
        l = lexicon_fst(
            lex_dis, tokens, words, sil_prob=0.0, sil_phone="sil",
            sil_disambig=f"#{ndisambig}",
        )
    elif dict_type == "char":
        l = lexicon_fst(
            lex_dis, tokens, words, sil_prob=0.5, sil_phone=space_char,
            sil_disambig=f"#{ndisambig}",
        )
    else:
        raise ValueError(f"bad dict_type {dict_type}")
    return Lang(tokens, words, t, l, ndisambig)
