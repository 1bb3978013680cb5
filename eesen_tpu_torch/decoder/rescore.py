"""Lattice language-model rescoring.

The capability of the reference's on-the-fly LM composition
(reference: src/lm/const-arpa-lm.{h,cc} — ConstArpaLmDeterministicFst: an
on-demand deterministic automaton over an ARPA LM, used to rescore
lattices with a bigger LM than the decoding graph's).

`LmAutomaton` wraps a G fst (from decoder.arpa.arpa_to_fst, with
#0-labeled backoff arcs) as a deterministic scorer: score(state, word)
follows backoff arcs until the word is found.  `rescore_lattice` composes
a word lattice with the automaton on the host (lattices are small DAGs),
replacing `lm_scale_old` of the original graph cost with the new LM score.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from eesen_tpu_torch.decoder.ctc_graph import SymbolTable
from eesen_tpu_torch.decoder.fst import EPS, Fst
from eesen_tpu_torch.decoder.lattice import Lattice, LatticeArc

INF = float("inf")


class LmAutomaton:
    """Deterministic view of a backoff G fst."""

    def __init__(self, g: Fst, backoff_ilabel: Optional[int] = None):
        self.g = g
        self.backoff_ilabel = backoff_ilabel
        # index arcs: per state, word -> (weight, dst); backoff -> (w, dst)
        self.trans: List[Dict[int, Tuple[float, int]]] = []
        self.backoff: List[Optional[Tuple[float, int]]] = []
        for s in range(g.num_states):
            d: Dict[int, Tuple[float, int]] = {}
            bo: Optional[Tuple[float, int]] = None
            for a in g.arcs[s]:
                if a.ilabel == EPS or (
                    backoff_ilabel is not None and a.ilabel == backoff_ilabel
                ):
                    bo = (a.weight, a.nextstate)
                else:
                    old = d.get(a.ilabel)
                    if old is None or a.weight < old[0]:
                        d[a.ilabel] = (a.weight, a.nextstate)
            self.trans.append(d)
            self.backoff.append(bo)

    @property
    def start(self) -> int:
        return self.g.start

    def score(self, state: int, word: int) -> Tuple[float, int]:
        """(cost, next_state), following backoff; inf if word impossible."""
        cost = 0.0
        for _ in range(64):
            hit = self.trans[state].get(word)
            if hit is not None:
                return cost + hit[0], hit[1]
            bo = self.backoff[state]
            if bo is None:
                return INF, state
            cost += bo[0]
            state = bo[1]
        return INF, state

    def final(self, state: int) -> float:
        cost = 0.0
        for _ in range(64):
            fw = self.g.final_weight(state)
            if fw != INF:
                return cost + fw
            bo = self.backoff[state]
            if bo is None:
                return INF
            cost += bo[0]
            state = bo[1]
        return INF


def rescore_lattice(
    lat: Lattice,
    lm: LmAutomaton,
    lm_scale_new: float = 1.0,
    old_graph_scale: float = 1.0,
) -> Lattice:
    """Product of the lattice with the LM automaton.

    New arcs carry graph_cost = old_graph_cost * old_graph_scale +
    lm_cost * lm_scale_new (to fully REPLACE the old LM contribution,
    build the decode graph with a weak LM and pass old_graph_scale for the
    remaining lexicon/pron weight, as the reference's rescoring recipes
    do)."""
    out = Lattice()
    ids: Dict[Tuple[int, int], int] = {}

    def get(ls: int, qs: int) -> int:
        key = (ls, qs)
        if key not in ids:
            ids[key] = out.add_state(lat.state_frame[ls])
        return ids[key]

    out.start = get(lat.start, lm.start)
    stack = [(lat.start, lm.start)]
    seen = {(lat.start, lm.start)}
    while stack:
        ls, qs = stack.pop()
        cur = ids[(ls, qs)]
        if ls in lat.finals:
            fw = lm.final(qs)
            if fw != INF:
                out.finals[cur] = (
                    lat.finals[ls] * old_graph_scale + fw * lm_scale_new
                )
        for a in lat.arcs[ls]:
            if a.olabel:
                lm_cost, nq = lm.score(qs, a.olabel)
                if lm_cost == INF:
                    continue
            else:
                lm_cost, nq = 0.0, qs
            nxt = get(a.nextstate, nq)
            out.arcs[cur].append(
                LatticeArc(
                    a.ilabel, a.olabel,
                    a.graph_cost * old_graph_scale + lm_cost * lm_scale_new,
                    a.acoustic_cost, nxt,
                )
            )
            if (a.nextstate, nq) not in seen:
                seen.add((a.nextstate, nq))
                stack.append((a.nextstate, nq))
    return out
