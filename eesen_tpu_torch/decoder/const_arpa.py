"""Compact const-arpa language model: a flat int/float-array trie.

The TPU-native equivalent of the reference's ConstArpaLm
(reference: src/lm/const-arpa-lm.h:32 — an int32-array LM-state image
built once from ARPA text, queried by binary search, written to disk and
memory-mapped back; :202 ConstArpaLmDeterministicFst exposes it to
lattice rescoring).  Where the reference packs states into one int32
blob with pointer arithmetic, this implementation keeps one struct-of-
arrays trie (numpy), which `np.load(mmap_mode="r")` maps back without
reading — the same zero-parse load path for multi-million-ngram LMs.

Interface matches decoder.rescore.LmAutomaton (start / score / final),
so `rescore_lattice` accepts either; ConstArpa skips the G-fst
materialization entirely and loads from disk in O(1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from eesen_tpu_torch.decoder.arpa import parse_arpa
from eesen_tpu_torch.decoder.ctc_graph import SymbolTable

INF = float("inf")
LN10 = math.log(10.0)
BOS, EOS = "<s>", "</s>"


class ConstArpa:
    """Flat-array backoff n-gram trie.

    States are LM histories (word-id tuples of length < order) with
    explicit continuations; arrays:
      child_base[S+1]           CSR offsets into the child arrays
      child_word[E]  int32      successor word ids, sorted per state
      child_cost[E]  float32    -ln p(w | h)
      child_next[E]  int32      state after consuming w (longest suffix)
      bow_cost[S]    float32    -ln backoff(h)
      suffix[S]      int32      state of h[1:]
    State 0 is the empty history (unigram root).
    """

    def __init__(self, child_base, child_word, child_cost, child_next,
                 bow_cost, suffix, start_state: int, eos_id: int,
                 order: int):
        self.child_base = child_base
        self.child_word = child_word
        self.child_cost = child_cost
        self.child_next = child_next
        self.bow_cost = bow_cost
        self.suffix = suffix
        self._start = int(start_state)
        self.eos_id = int(eos_id)
        self.order = int(order)

    # ---- construction ----
    @classmethod
    def from_arpa(cls, arpa_text: str, words: SymbolTable) -> "ConstArpa":
        grams = parse_arpa(arpa_text)
        order = len(grams)

        def wid(w: str) -> Optional[int]:
            if w == BOS:
                return -1          # sentinel: BOS is a history-only word
            if w == EOS:
                return -2
            return words[w] if w in words else None

        prob: Dict[Tuple[int, ...], float] = {}
        bow: Dict[Tuple[int, ...], float] = {}
        for k, entries in enumerate(grams, 1):
            for logp, ng, bo in entries:
                ids = tuple(wid(w) for w in ng)
                if any(i is None for i in ids):
                    continue       # OOV ngram (reference skips the same)
                prob[ids] = -logp * LN10
                if bo is not None and k < order:
                    bow[ids] = -bo * LN10

        # states: empty history + every context of a stored ngram
        states: Dict[Tuple[int, ...], int] = {(): 0}
        for ng in prob:
            h = ng[:-1]
            while h and h not in states:
                states.setdefault(h, len(states))
                h = h[:-1]
        # histories longer than order-1 never occur by construction
        n_states = len(states)
        by_state: List[List[Tuple[int, float, Tuple[int, ...]]]] = [
            [] for _ in range(n_states)
        ]
        for ng, cost in prob.items():
            h = ng[:-1]
            if len(ng) == 1 and ng[0] == -1:
                continue           # p(<s>) is a placeholder, never queried
            if h in states:
                by_state[states[h]].append((ng[-1], cost, ng))

        def next_state(ng: Tuple[int, ...]) -> int:
            s = ng[-(order - 1):] if order > 1 else ()
            while s and s not in states:
                s = s[1:]
            return states.get(s, 0)
        child_base = np.zeros(n_states + 1, np.int64)
        words_l, costs_l, nexts_l = [], [], []
        for s in range(n_states):
            items = sorted(by_state[s])
            child_base[s + 1] = child_base[s] + len(items)
            for w, cost, ng in items:
                words_l.append(w)
                costs_l.append(cost)
                nexts_l.append(next_state(ng))
        bow_cost = np.zeros(n_states, np.float32)
        suffix = np.zeros(n_states, np.int32)
        for h, s in states.items():
            bow_cost[s] = bow.get(h, 0.0)
            t = h[1:]
            while t and t not in states:
                t = t[1:]
            suffix[s] = states.get(t, 0)
        start = states.get((-1,), 0)
        return cls(
            child_base.astype(np.int64),
            np.asarray(words_l, np.int32),
            np.asarray(costs_l, np.float32),
            np.asarray(nexts_l, np.int32),
            bow_cost, suffix, start, -2, order,
        )

    # ---- persistence (mmap-able) ----
    def save(self, path: str) -> None:
        np.savez(
            path, child_base=self.child_base, child_word=self.child_word,
            child_cost=self.child_cost, child_next=self.child_next,
            bow_cost=self.bow_cost, suffix=self.suffix,
            meta=np.asarray([self._start, self.eos_id, self.order],
                            np.int64),
        )

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "ConstArpa":
        z = np.load(path, mmap_mode="r" if mmap else None)
        meta = np.asarray(z["meta"])
        return cls(
            z["child_base"], z["child_word"], z["child_cost"],
            z["child_next"], z["bow_cost"], z["suffix"],
            int(meta[0]), int(meta[1]), int(meta[2]),
        )

    @property
    def num_states(self) -> int:
        return len(self.bow_cost)

    @property
    def num_ngrams(self) -> int:
        return len(self.child_word)

    def bytes(self) -> int:
        return sum(
            a.nbytes for a in (
                self.child_base, self.child_word, self.child_cost,
                self.child_next, self.bow_cost, self.suffix,
            )
        )

    # ---- LmAutomaton interface ----
    @property
    def start(self) -> int:
        return self._start

    def score(self, state: int, word: int) -> Tuple[float, int]:
        """(cost, next_state) with backoff; inf if impossible."""
        cost = 0.0
        cb, cw = self.child_base, self.child_word
        while True:
            lo, hi = int(cb[state]), int(cb[state + 1])
            j = lo + int(np.searchsorted(cw[lo:hi], word))
            if j < hi and cw[j] == word:
                return cost + float(self.child_cost[j]), \
                    int(self.child_next[j])
            if state == 0:
                return INF, 0
            cost += float(self.bow_cost[state])
            state = int(self.suffix[state])

    def final(self, state: int) -> float:
        c, _ = self.score(state, self.eos_id)
        return c
