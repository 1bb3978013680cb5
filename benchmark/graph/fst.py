"""Weighted finite-state transducers: the structure the graph build
hands to the native library (fstlib.cpp) and the few operations done on
it in Python.

`Fst` is a mutable WFST with dense state ids and a list of arcs a state;
the token and lexicon FSTs (ctc_graph.py) and the grammar (arpa.py) are
built as `Fst`s.  Here: `arcsort`, `connect` (fst::Connect) and
`add_self_loops` (src/fstbin/fstaddselfloops.cc, the disambiguation
self-loops of L).  Composition, determinization, minimization and the
compilation to device tables run in C++ (fst_native.build_full_compiled).
Weights are tropical, with +inf as the semiring zero.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

EPS = 0            # epsilon label id, matches OpenFst convention


@dataclasses.dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float
    nextstate: int


class Fst:
    """Mutable WFST; states are dense ints, arcs per-state lists."""

    def __init__(self) -> None:
        self.arcs: List[List[Arc]] = []
        self.finals: Dict[int, float] = {}
        self.start: int = -1

    # ---- construction ----
    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def add_arc(self, state: int, arc: Arc) -> None:
        self.arcs[state].append(arc)

    def set_start(self, s: int) -> None:
        self.start = s

    def set_final(self, s: int, weight: float = 0.0) -> None:
        self.finals[s] = weight

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def copy(self) -> "Fst":
        f = Fst()
        f.arcs = [[dataclasses.replace(a) for a in arcs] for arcs in self.arcs]
        f.finals = dict(self.finals)
        f.start = self.start
        return f


def arcsort(fst: Fst, sort_type: str = "ilabel") -> Fst:
    key = (lambda a: (a.ilabel, a.olabel)) if sort_type == "ilabel" else (
        lambda a: (a.olabel, a.ilabel)
    )
    out = fst.copy()
    for arcs in out.arcs:
        arcs.sort(key=key)
    return out


def connect(fst: Fst) -> Fst:
    """Trim states not on a successful path (fst::Connect)."""
    n = fst.num_states
    if fst.start < 0 or n == 0:
        return Fst()
    # forward reachable
    fwd = np.zeros(n, dtype=bool)
    stack = [fst.start]
    fwd[fst.start] = True
    while stack:
        s = stack.pop()
        for a in fst.arcs[s]:
            if not fwd[a.nextstate]:
                fwd[a.nextstate] = True
                stack.append(a.nextstate)
    # backward reachable from finals
    rev: List[List[int]] = [[] for _ in range(n)]
    for s in range(n):
        for a in fst.arcs[s]:
            rev[a.nextstate].append(s)
    bwd = np.zeros(n, dtype=bool)
    stack = [s for s in fst.finals if fwd[s]]
    for s in stack:
        bwd[s] = True
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if not bwd[p]:
                bwd[p] = True
                stack.append(p)
    keep = fwd & bwd
    remap = -np.ones(n, dtype=np.int64)
    out = Fst()
    for s in range(n):
        if keep[s]:
            remap[s] = out.add_state()
    if not keep[fst.start]:
        return Fst()
    out.set_start(int(remap[fst.start]))
    for s in range(n):
        if not keep[s]:
            continue
        for a in fst.arcs[s]:
            if keep[a.nextstate]:
                out.add_arc(
                    int(remap[s]),
                    Arc(a.ilabel, a.olabel, a.weight, int(remap[a.nextstate])),
                )
        if s in fst.finals:
            out.set_final(int(remap[s]), fst.finals[s])
    return out


def add_self_loops(
    fst: Fst, isyms: Sequence[int], osyms: Sequence[int]
) -> Fst:
    """Add self-loops with (isym, osym) pairs at every state that has
    epsilon output arcs leaving it or is final
    (reference: src/fstbin/fstaddselfloops.cc:43 — used to pass disambig
    symbols through L)."""
    out = fst.copy()
    for s in range(out.num_states):
        needs = s in out.finals or any(
            a.olabel == EPS for a in out.arcs[s]
        )
        if needs:
            for i, o in zip(isyms, osyms):
                out.add_arc(s, Arc(i, o, 0.0, s))
    return out
