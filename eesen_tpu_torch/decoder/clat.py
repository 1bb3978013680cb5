"""CompactLattice: the (pair-weight, ilabel-string) semiring + pruned
word-level determinization.

The reference represents post-decode lattices as CompactLattice — an
acceptor over words whose weights are CompactLatticeWeight = (LatticeWeight
pair, ilabel string); determinization merges every path with the same word
sequence, keeping the single best (graph, acoustic, alignment) triple, with
beam pruning interleaved so unpromising subsets are never expanded
(reference: src/fstext/lattice-weight.h:394-676 semiring ops/Compare;
src/lat/determinize-lattice-pruned.h:189 DeterminizeLatticePruned,
invoked from src/decoder/decoder-wrappers.cc:87-99).

This is a fresh host-side implementation over our Lattice type (lattices
are small pruned DAGs; the reference also runs this on the host CPU).
Semantics kept:
  - pair order: smaller graph+acoustic total wins, ties by smaller graph
    cost (lattice-weight.h:295-308 Compare);
  - compact order: pair first, then SHORTER ilabel string, then
    lexicographic (lattice-weight.h:562-576 Compare);
  - subsets are normalized by factoring out the minimal weight and the
    longest common prefix of strings (the "common divisor"), so equal
    residual subsets merge;
  - beam pruning uses exact backward costs from the input lattice:
    an element is dropped when (forward cost of the subset) + (element
    residual) + (best completion) exceeds best_path + beam.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from eesen_tpu_torch.decoder.lattice import Lattice, LatticeArc

INF = float("inf")

Pair = Tuple[float, float]            # (graph_cost, acoustic_cost)
IString = Tuple[int, ...]


def pair_compare(w1: Pair, w2: Pair) -> int:
    """-1 if w1 is better (smaller), +1 if worse, 0 if equal.
    (Note: the reference's Compare returns +1 for 'larger in the semiring'
    = smaller cost; we use plain 'is-better' ordering host-side.)"""
    t1, t2 = w1[0] + w1[1], w2[0] + w2[1]
    if t1 != t2:
        return -1 if t1 < t2 else 1
    if w1[0] != w2[0]:
        return -1 if w1[0] < w2[0] else 1
    return 0


def clat_compare(w1: Pair, s1: IString, w2: Pair, s2: IString) -> int:
    """CompactLatticeWeight order: pair, then shorter string, then lex."""
    c = pair_compare(w1, w2)
    if c != 0:
        return c
    if len(s1) != len(s2):
        return -1 if len(s1) < len(s2) else 1
    if s1 != s2:
        return -1 if s1 < s2 else 1
    return 0


@dataclasses.dataclass
class CompactArc:
    """Acceptor arc: word label + (pair weight, ilabel string)."""
    word: int
    graph_cost: float
    acoustic_cost: float
    ilabels: IString
    nextstate: int


class CompactLattice:
    """Word-acceptor lattice in the CompactLatticeWeight semiring."""

    def __init__(self) -> None:
        self.arcs: List[List[CompactArc]] = []
        # state -> (graph_cost, acoustic_cost, ilabel string)
        self.finals: Dict[int, Tuple[float, float, IString]] = {}
        self.start: int = 0

    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def scale(self, acoustic_scale: float, lm_scale: float = 1.0) -> None:
        """lattice-scale semantics (decoderbin/lattice-scale.cc): scale the
        two cost components independently; alignments untouched."""
        for arcs in self.arcs:
            for a in arcs:
                a.acoustic_cost *= acoustic_scale
                a.graph_cost *= lm_scale
        for s in list(self.finals):
            g, ac, il = self.finals[s]
            self.finals[s] = (g * lm_scale, ac * acoustic_scale, il)

    def scaled(self, acoustic_scale: float, lm_scale: float = 1.0
               ) -> "CompactLattice":
        out = CompactLattice()
        out.start = self.start
        for arcs in self.arcs:
            out.add_state()
            out.arcs[-1] = [
                CompactArc(a.word, a.graph_cost * lm_scale,
                           a.acoustic_cost * acoustic_scale, a.ilabels,
                           a.nextstate)
                for a in arcs
            ]
        out.finals = {
            s: (g * lm_scale, ac * acoustic_scale, il)
            for s, (g, ac, il) in self.finals.items()
        }
        return out

    def add_penalty(self, word_ins_penalty: float) -> None:
        """decoderbin/lattice-add-penalty.cc: penalty on word arcs."""
        for arcs in self.arcs:
            for a in arcs:
                if a.word:
                    a.graph_cost += word_ins_penalty

    def topo_order(self) -> List[int]:
        n = self.num_states
        indeg = [0] * n
        for s in range(n):
            for a in self.arcs[s]:
                indeg[a.nextstate] += 1
        order: List[int] = []
        stack = [s for s in range(n) if indeg[s] == 0]
        while stack:
            s = stack.pop()
            order.append(s)
            for a in self.arcs[s]:
                indeg[a.nextstate] -= 1
                if indeg[a.nextstate] == 0:
                    stack.append(a.nextstate)
        return order

    def best_path(self) -> Tuple[List[int], List[int], float]:
        """Viterbi -> (ilabels, words, cost) over graph+acoustic total
        (decoderbin/lattice-best-path.cc on the compact lattice)."""
        n = self.num_states
        dist = [INF] * n
        back: List[Optional[Tuple[int, CompactArc]]] = [None] * n
        dist[self.start] = 0.0
        for s in self.topo_order():
            if not math.isfinite(dist[s]):
                continue
            for a in self.arcs[s]:
                nd = dist[s] + a.graph_cost + a.acoustic_cost
                if nd < dist[a.nextstate]:
                    dist[a.nextstate] = nd
                    back[a.nextstate] = (s, a)
        best_s, best_c = -1, INF
        for s, (g, ac, il) in self.finals.items():
            c = dist[s] + g + ac
            if c < best_c:
                best_c, best_s = c, s
        if best_s < 0:
            return [], [], INF
        s = best_s
        ils: List[int] = list(self.finals[s][2])
        words: List[int] = []
        while back[s] is not None:
            p, a = back[s]
            ils = list(a.ilabels) + ils
            if a.word:
                words.append(a.word)
            s = p
        words.reverse()
        return ils, words, best_c

    def prune(self, lattice_beam: float) -> None:
        """lattice-prune semantics on the total cost."""
        n = self.num_states
        order = self.topo_order()
        fwd = [INF] * n
        fwd[self.start] = 0.0
        for s in order:
            if not math.isfinite(fwd[s]):
                continue
            for a in self.arcs[s]:
                c = fwd[s] + a.graph_cost + a.acoustic_cost
                if c < fwd[a.nextstate]:
                    fwd[a.nextstate] = c
        bwd = [INF] * n
        for s, (g, ac, _) in self.finals.items():
            bwd[s] = g + ac
        for s in reversed(order):
            for a in self.arcs[s]:
                c = a.graph_cost + a.acoustic_cost + bwd[a.nextstate]
                if c < bwd[s]:
                    bwd[s] = c
        best = min(
            (fwd[s] + g + ac for s, (g, ac, _) in self.finals.items()
             if math.isfinite(fwd[s])),
            default=INF,
        )
        cutoff = best + lattice_beam
        for s in range(n):
            self.arcs[s] = [
                a for a in self.arcs[s]
                if fwd[s] + a.graph_cost + a.acoustic_cost
                + bwd[a.nextstate] <= cutoff
            ]
        for s in list(self.finals):
            g, ac, _ = self.finals[s]
            if fwd[s] + g + ac > cutoff:
                del self.finals[s]


def compact_to_lattice(clat: CompactLattice) -> Lattice:
    """Expand CompactLattice arcs back to state-level Lattice chains
    (reference ConvertLattice semantics: the word + full weight go on the
    first arc of the chain, one alignment ilabel per arc)."""
    lat = Lattice()
    for _ in range(clat.num_states):
        lat.add_state(-1)
    lat.start = clat.start
    for s in range(clat.num_states):
        for a in clat.arcs[s]:
            ils = a.ilabels or (0,)
            cur = s
            for i, il in enumerate(ils):
                last = i == len(ils) - 1
                dst = a.nextstate if last else lat.add_state(-1)
                lat.arcs[cur].append(LatticeArc(
                    il, a.word if i == 0 else 0,
                    a.graph_cost if i == 0 else 0.0,
                    a.acoustic_cost if i == 0 else 0.0,
                    dst,
                ))
                cur = dst
    for s, (g, ac, fil) in clat.finals.items():
        if not fil:
            lat.finals[s] = g + ac
        else:
            cur = s
            for i, il in enumerate(fil):
                dst = lat.add_state(-1)
                lat.arcs[cur].append(LatticeArc(
                    il, 0, g if i == 0 else 0.0, ac if i == 0 else 0.0,
                    dst,
                ))
                cur = dst
            lat.finals[cur] = 0.0
    from eesen_tpu_torch.decoder.lattice_io import _assign_frames
    _assign_frames(lat)
    return lat


def lattice_to_compact(lat: Lattice) -> CompactLattice:
    """Straight conversion, no determinization (ConvertLattice direction
    Lattice->CompactLattice: each arc's ilabel becomes a 1-string)."""
    out = CompactLattice()
    for _ in range(lat.num_states):
        out.add_state()
    out.start = lat.start
    for s in range(lat.num_states):
        for a in lat.arcs[s]:
            out.arcs[s].append(CompactArc(
                a.olabel, a.graph_cost, a.acoustic_cost,
                (a.ilabel,) if a.ilabel else (), a.nextstate,
            ))
    for s, w in lat.finals.items():
        out.finals[s] = (w, 0.0, ())
    return out


# ---------------------------------------------------------------------
# Pruned determinization
# ---------------------------------------------------------------------

# one element of a determinization subset: input state + residual
# (pair weight, ilabel string) relative to the subset's common divisor
_Elem = Tuple[int, float, float, IString]


def _topo_order_lattice(lat: Lattice) -> List[int]:
    n = lat.num_states
    indeg = [0] * n
    for s in range(n):
        for a in lat.arcs[s]:
            indeg[a.nextstate] += 1
    order: List[int] = []
    stack = [s for s in range(n) if indeg[s] == 0]
    while stack:
        s = stack.pop()
        order.append(s)
        for a in lat.arcs[s]:
            indeg[a.nextstate] -= 1
            if indeg[a.nextstate] == 0:
                stack.append(a.nextstate)
    if len(order) != n:
        raise ValueError("lattice has a cycle; cannot determinize")
    return order


def _backward_best(lat: Lattice, order: List[int]) -> List[float]:
    """beta[s] = best total cost from s to a final state."""
    beta = [INF] * lat.num_states
    for s, w in lat.finals.items():
        beta[s] = w
    for s in reversed(order):
        for a in lat.arcs[s]:
            c = a.graph_cost + a.acoustic_cost + beta[a.nextstate]
            if c < beta[s]:
                beta[s] = c
    return beta


def _eps_closure(
    elems: List[_Elem], lat: Lattice, topo_pos: List[int]
) -> List[_Elem]:
    """Close a set of elements over olabel=0 arcs, absorbing ilabels into
    the strings.  Lattices are acyclic, so a heap ordered by topological
    position visits every input state after all its eps predecessors."""
    best: Dict[int, Tuple[float, float, IString]] = {}
    heap: List[Tuple[int, int]] = []      # (topo_pos, state)
    for (s, g, a, il) in elems:
        cur = best.get(s)
        if cur is None or clat_compare(
            (g, a), il, (cur[0], cur[1]), cur[2]
        ) < 0:
            best[s] = (g, a, il)
            heapq.heappush(heap, (topo_pos[s], s))
    done: Dict[int, Tuple[float, float, IString]] = {}
    while heap:
        _, s = heapq.heappop(heap)
        if s in done and done[s] == best[s]:
            continue
        done[s] = best[s]
        g, a, il = best[s]
        for arc in lat.arcs[s]:
            if arc.olabel != 0:
                continue
            ng = g + arc.graph_cost
            na = a + arc.acoustic_cost
            nil = il + ((arc.ilabel,) if arc.ilabel else ())
            d = arc.nextstate
            cur = best.get(d)
            if cur is None or clat_compare(
                (ng, na), nil, (cur[0], cur[1]), cur[2]
            ) < 0:
                best[d] = (ng, na, nil)
                heapq.heappush(heap, (topo_pos[d], d))
    return [(s, g, a, il) for s, (g, a, il) in best.items()]


def _normalize(
    elems: List[_Elem],
) -> Tuple[Pair, IString, Tuple[_Elem, ...]]:
    """Factor out the common divisor: minimal weight (in the compact
    order) and the longest common prefix of strings."""
    bg, ba = INF, INF
    for (s, g, a, il) in elems:
        if pair_compare((g, a), (bg, ba)) < 0:
            bg, ba = g, a
    prefix: Optional[IString] = None
    for (s, g, a, il) in elems:
        if prefix is None:
            prefix = il
        else:
            k = 0
            while k < len(prefix) and k < len(il) and prefix[k] == il[k]:
                k += 1
            prefix = prefix[:k]
        if not prefix:
            break
    prefix = prefix or ()
    p = len(prefix)
    norm = tuple(sorted(
        (s, g - bg, a - ba, il[p:]) for (s, g, a, il) in elems
    ))
    return (bg, ba), prefix, norm


def determinize_lattice_pruned(
    lat: Lattice,
    lattice_beam: float = 8.0,
    max_states: int = 200000,
    max_arcs: int = 1000000,
) -> CompactLattice:
    """Word-level determinization in the CompactLatticeWeight semiring
    with interleaved beam pruning.

    Every distinct word sequence keeps exactly one path whose weight is
    the minimum (graph, acoustic) pair over input paths and whose string
    is that best path's frame-level alignment — the reference's
    DeterminizeLatticePruned (src/lat/determinize-lattice-pruned.h:189)
    applied post-decode (decoder-wrappers.cc:87-99).  Subsets are expanded
    best-first so the max_states/max_arcs safety valves drop only the
    worst paths; returns the (possibly partial) result in that case, as
    the reference does.
    """
    out = CompactLattice()
    if lat.num_states == 0 or not lat.finals:
        out.add_state()
        return out
    order = _topo_order_lattice(lat)
    topo_pos = [0] * lat.num_states
    for i, s in enumerate(order):
        topo_pos[s] = i
    beta = _backward_best(lat, order)
    best_cost = beta[lat.start]
    if not math.isfinite(best_cost):
        out.add_state()
        return out
    cutoff = best_cost + lattice_beam

    def prune_elems(elems: List[_Elem], fwd: float) -> List[_Elem]:
        return [
            (s, g, a, il) for (s, g, a, il) in elems
            if fwd + g + a + beta[s] <= cutoff + 1e-6
        ]

    init = _eps_closure([(lat.start, 0.0, 0.0, ())], lat, topo_pos)
    init = prune_elems(init, 0.0)
    (ig, ia), iprefix, init_norm = _normalize(init)
    # the initial divisor can't go on an arc; re-attach it to the elements
    init_full = tuple(
        (s, g + ig, a + ia, iprefix + il) for (s, g, a, il) in init_norm
    )

    subset_id: Dict[Tuple[_Elem, ...], int] = {init_full: out.add_state()}
    subset_fwd: Dict[int, float] = {0: 0.0}
    # best-first worklist by forward cost (determinize-lattice-pruned
    # processes high-scoring subsets first so early termination is safe)
    heap: List[Tuple[float, int, Tuple[_Elem, ...]]] = [
        (0.0, 0, init_full)
    ]
    n_arcs = 0
    while heap:
        fwd, sid, elems = heapq.heappop(heap)
        if fwd > subset_fwd.get(sid, INF) + 1e-9:
            continue
        # finals
        fbest: Optional[Tuple[float, float, IString]] = None
        for (s, g, a, il) in elems:
            if s in lat.finals:
                cand = (g + lat.finals[s], a, il)
                if fbest is None or clat_compare(
                    (cand[0], cand[1]), cand[2],
                    (fbest[0], fbest[1]), fbest[2],
                ) < 0:
                    fbest = cand
        if fbest is not None:
            out.finals[sid] = fbest
        # group outgoing word arcs
        by_word: Dict[int, List[_Elem]] = {}
        for (s, g, a, il) in elems:
            for arc in lat.arcs[s]:
                if arc.olabel == 0:
                    continue
                by_word.setdefault(arc.olabel, []).append((
                    arc.nextstate, g + arc.graph_cost,
                    a + arc.acoustic_cost,
                    il + ((arc.ilabel,) if arc.ilabel else ()),
                ))
        for word in sorted(by_word):
            closed = _eps_closure(by_word[word], lat, topo_pos)
            closed = prune_elems(closed, fwd)
            if not closed:
                continue
            (dg, da), prefix, norm = _normalize(closed)
            nfwd = fwd + dg + da
            tid = subset_id.get(norm)
            if tid is None:
                if out.num_states >= max_states or n_arcs >= max_arcs:
                    continue            # safety valve: drop worst paths
                tid = out.add_state()
                subset_id[norm] = tid
                subset_fwd[tid] = nfwd
                heapq.heappush(heap, (nfwd, tid, norm))
            elif nfwd < subset_fwd.get(tid, INF) - 1e-9:
                # a better entry path to an existing subset: re-relax so
                # pruning thresholds stay conservative
                subset_fwd[tid] = nfwd
                heapq.heappush(heap, (nfwd, tid, norm))
            out.arcs[sid].append(
                CompactArc(word, dg, da, prefix, tid)
            )
            n_arcs += 1
    out.start = 0
    return out


# --------------------------------------------------------------------------
# push + minimize (reference: src/lat/push-lattice.{h,cc},
# src/lat/minimize-lattice.{h,cc} — called after pruned determinization to
# canonicalize and shrink lattices)
# --------------------------------------------------------------------------

def _common_prefix(strings: List[IString]) -> IString:
    if not strings:
        return ()
    first = min(strings, key=len)
    k = len(first)
    for s in strings:
        j = 0
        while j < k and s[j] == first[j]:
            j += 1
        k = j
        if k == 0:
            return ()
    return tuple(first[:k])


def push_strings(clat: CompactLattice) -> None:
    """Push ilabel (frame-alignment) strings as far toward the start as
    they will go (reference: PushCompactLatticeStrings,
    src/lat/push-lattice.h:38 — OpenFst's generic push does not apply in
    this semiring because ⊕ does not divide the operands).  In-place;
    reverse-topological one-pass, exact on acyclic lattices."""
    order = clat.topo_order()
    prefix: List[IString] = [()] * clat.num_states
    for s in reversed(order):
        items = [
            tuple(a.ilabels) + prefix[a.nextstate] for a in clat.arcs[s]
        ]
        if s in clat.finals:
            items.append(tuple(clat.finals[s][2]))
        pfx = () if s == clat.start else _common_prefix(items)
        prefix[s] = pfx
        for a in clat.arcs[s]:
            full = tuple(a.ilabels) + prefix[a.nextstate]
            a.ilabels = full[len(pfx):]
        if s in clat.finals:
            g, ac, il = clat.finals[s]
            clat.finals[s] = (g, ac, tuple(il)[len(pfx):])


def push_weights(clat: CompactLattice) -> None:
    """Push (graph, acoustic) weights toward the start so every state but
    the start "sums to one" in the LatticeWeight semiring — i.e. the
    ⊕-sum (min by total cost, graph tie-break) of its outgoing ⊗ suffix
    weights is (0, 0) (reference: PushCompactLatticeWeights,
    src/lat/push-lattice.h:51).  In-place; exact on acyclic lattices."""
    order = clat.topo_order()
    n = clat.num_states
    resid: List[Pair] = [(0.0, 0.0)] * n
    for s in reversed(order):
        cands: List[Pair] = []
        for a in clat.arcs[s]:
            rg, ra = resid[a.nextstate]
            cands.append((a.graph_cost + rg, a.acoustic_cost + ra))
        if s in clat.finals:
            g, ac, _ = clat.finals[s]
            cands.append((g, ac))
        if not cands or s == clat.start:
            # the start state is never divided (it carries the total path
            # weight) but its arcs still absorb the successors' residuals
            w = (0.0, 0.0)
        else:
            w = cands[0]
            for c in cands[1:]:
                if pair_compare(c, w) < 0:
                    w = c
        resid[s] = w
        for a in clat.arcs[s]:
            rg, ra = resid[a.nextstate]
            a.graph_cost += rg - w[0]
            a.acoustic_cost += ra - w[1]
        if s in clat.finals:
            g, ac, il = clat.finals[s]
            clat.finals[s] = (g - w[0], ac - w[1], il)
    # the start state keeps the whole path weight: fold residuals of the
    # start's successors into its arcs (done above via resid[dst]); the
    # start's own residual stays un-divided by construction


def minimize(clat: CompactLattice, delta: float = 1.0 / 1024.0
             ) -> CompactLattice:
    """Suffix-sharing minimization of a determinized (acyclic) lattice
    (reference: MinimizeCompactLattice, src/lat/minimize-lattice.h:42 —
    'to be called after determinization and pushing').  States with
    identical outgoing signatures (word, quantized costs, ilabels,
    successor class, final weight) merge; exact on acyclic input via one
    reverse-topological signature pass."""
    order = clat.topo_order()
    n = clat.num_states
    rep: List[int] = [0] * n          # state -> class id
    classes: Dict[tuple, int] = {}
    q = lambda x: round(x / delta)
    for s in reversed(order):
        fin = clat.finals.get(s)
        sig_fin = (
            None if fin is None
            else (q(fin[0]), q(fin[1]), tuple(fin[2]))
        )
        sig = (
            sig_fin,
            tuple(sorted(
                (a.word, q(a.graph_cost), q(a.acoustic_cost),
                 tuple(a.ilabels), rep[a.nextstate])
                for a in clat.arcs[s]
            )),
        )
        if sig not in classes:
            classes[sig] = len(classes)
        rep[s] = classes[sig]
    # rebuild: one state per class reachable from the start's class
    out = CompactLattice()
    class_state: Dict[int, int] = {}

    def get_state(c: int) -> int:
        if c not in class_state:
            class_state[c] = out.add_state()
        return class_state[c]

    done = set()
    stack = [clat.start]
    out.start = get_state(rep[clat.start])
    src_of_class = {}
    for s in order:               # first representative in topo order
        src_of_class.setdefault(rep[s], s)
    while stack:
        s = stack.pop()
        c = rep[s]
        if c in done:
            continue
        done.add(c)
        s0 = src_of_class[c]
        os_ = get_state(c)
        for a in clat.arcs[s0]:
            dc = rep[a.nextstate]
            out.arcs[os_].append(CompactArc(
                a.word, a.graph_cost, a.acoustic_cost, tuple(a.ilabels),
                get_state(dc),
            ))
            stack.append(a.nextstate)
        if s0 in clat.finals:
            out.finals[os_] = clat.finals[s0]
    return out


# ---------------------------------------------------------------------
# Sentence-level confidence
# ---------------------------------------------------------------------

def sentence_confidence(
    clat: CompactLattice,
) -> Tuple[float, int, List[int], List[int]]:
    """Best-vs-second-best margin over a determinized lattice
    (reference: src/lat/confidence.h:57, confidence.cc:26-84
    SentenceLevelConfidence on a CompactLattice).

    Returns (confidence, num_paths, best_sentence, second_best_sentence):
    the total-cost difference between the two best paths (which have
    distinct word sequences because the input is determinized), +inf if
    the lattice has only one path, and 0.0 if it has none.  Any acoustic
    scaling must already be applied (same contract as the reference).
    """
    # Work on the expanded state-level lattice: n-best over CompactLattice
    # arcs would append alignment strings quadratically, the same reason
    # the reference converts first (confidence.cc:31-38).
    lat = compact_to_lattice(clat)
    paths = lat.nbest(2)
    n = len(paths)
    best = paths[0][0] if n >= 1 else []
    second = paths[1][0] if n >= 2 else []
    if n == 0:
        return 0.0, 0, best, second
    if n == 1:
        return INF, 1, best, second
    ans = paths[1][1] - paths[0][1]
    return max(ans, 0.0), 2, best, second


def sentence_confidence_lattice(
    lat: Lattice,
) -> Tuple[float, int, List[int], List[int]]:
    """SentenceLevelConfidence on a raw state-level lattice
    (confidence.cc:87-117): determinize with an arc budget just large
    enough to surface the two best word sequences, then measure the
    margin on the result."""
    # longest sentence length = max words over any path (the reference's
    # LongestSentenceLength, lattice-functions.cc)
    order = _topo_order_lattice(lat)
    longest = [0] * lat.num_states
    for s in order:
        for a in lat.arcs[s]:
            cand = longest[s] + (1 if a.olabel else 0)
            if cand > longest[a.nextstate]:
                longest[a.nextstate] = cand
    max_len = max(
        (longest[s] for s in lat.finals), default=0
    )
    safety = 4 + max_len
    clat = determinize_lattice_pruned(
        lat, lattice_beam=INF, max_arcs=max_len * 2 + safety,
    )
    return sentence_confidence(clat)
