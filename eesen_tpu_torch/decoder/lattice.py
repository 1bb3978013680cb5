"""Lattices: generation from beam-search outputs + post-processing.

The reference generates lattices during decoding via per-token ForwardLinks
(reference: src/decoder/lattice-faster-decoder.{h,cc}:209-266 Token/
ForwardLink, GetRawLattice :111) and post-processes them with separate
binaries (src/decoderbin/: lattice-scale, lattice-best-path,
lattice-to-nbest, nbest-to-ctm, lattice-prune; src/lat/kaldi-lattice.h:32-46
the (graph_cost, acoustic_cost) pair semiring).

Here the TPU beam search (decoder/beam.py) emits per-frame active sets; the
lattice is reconstructed host-side by re-expanding arcs between surviving
tokens of consecutive frames — giving the same structure the reference
builds online.  Lattice arcs carry (graph_cost, acoustic_cost) separately,
so acoustic-scale sweeps (local/score.sh:44-55) rescale without
re-decoding.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from eesen_tpu_torch.decoder.beam import BeamOutputs
from eesen_tpu_torch.decoder.graph_compile import CompiledGraph

INF = float("inf")


@dataclasses.dataclass
class LatticeArc:
    """Arc with the two-part weight of the reference's LatticeWeight
    (fstext/lattice-weight.h:47: graph cost + acoustic cost kept apart)."""
    ilabel: int          # graph token id (frame-level), 0 for eps
    olabel: int          # word id, 0 for eps
    graph_cost: float
    acoustic_cost: float
    nextstate: int


class Lattice:
    """Host lattice: states in topological (frame) order, arcs between
    surviving beam tokens."""

    def __init__(self) -> None:
        self.arcs: List[List[LatticeArc]] = []
        self.finals: Dict[int, float] = {}
        self.start: int = 0
        self.state_frame: List[int] = []

    def add_state(self, frame: int) -> int:
        self.arcs.append([])
        self.state_frame.append(frame)
        return len(self.arcs) - 1

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def scale(self, acoustic_scale: float, lm_scale: float = 1.0) -> None:
        """lattice-scale semantics (decoderbin/lattice-scale.cc)."""
        for arcs in self.arcs:
            for a in arcs:
                a.acoustic_cost *= acoustic_scale
                a.graph_cost *= lm_scale

    def add_penalty(self, word_ins_penalty: float) -> None:
        """Add a word-insertion penalty to every word-bearing arc
        (decoderbin/lattice-add-penalty.cc)."""
        for arcs in self.arcs:
            for a in arcs:
                if a.olabel:
                    a.graph_cost += word_ins_penalty

    def prune(self, lattice_beam: float) -> None:
        """Drop arcs/states whose best path cost exceeds best + beam
        (lat/lattice-functions.cc PruneLattice semantics)."""
        n = self.num_states
        order = np.argsort(np.asarray(self.state_frame), kind="stable")
        fwd = np.full(n, INF)
        fwd[self.start] = 0.0
        for s in order:
            if not np.isfinite(fwd[s]):
                continue
            for a in self.arcs[s]:
                c = fwd[s] + a.graph_cost + a.acoustic_cost
                if c < fwd[a.nextstate]:
                    fwd[a.nextstate] = c
        bwd = np.full(n, INF)
        for s, w in self.finals.items():
            bwd[s] = w
        for s in order[::-1]:
            for a in self.arcs[s]:
                c = a.graph_cost + a.acoustic_cost + bwd[a.nextstate]
                if c < bwd[s]:
                    bwd[s] = c
        best = min(
            (fwd[s] + w for s, w in self.finals.items()
             if np.isfinite(fwd[s])),
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
            if fwd[s] + self.finals[s] > cutoff:
                del self.finals[s]

    def posterior_arcs(self) -> List[Tuple[int, float, int, int]]:
        """Word-arc posteriors: (word, posterior, start_frame, end_frame)
        over the log-semiring forward-backward (for MBR/confidence)."""
        n = self.num_states
        order = np.argsort(np.asarray(self.state_frame), kind="stable")
        neg_inf = -INF

        def logadd(a, b):
            if a == neg_inf:
                return b
            if b == neg_inf:
                return a
            hi, lo = (a, b) if a > b else (b, a)
            return hi + math.log1p(math.exp(lo - hi))

        alpha = np.full(n, neg_inf)
        alpha[self.start] = 0.0
        for s in order:
            if alpha[s] == neg_inf:
                continue
            for a in self.arcs[s]:
                w = -(a.graph_cost + a.acoustic_cost)
                alpha[a.nextstate] = logadd(
                    alpha[a.nextstate], alpha[s] + w
                )
        beta = np.full(n, neg_inf)
        for s, w in self.finals.items():
            beta[s] = -w
        for s in order[::-1]:
            for a in self.arcs[s]:
                w = -(a.graph_cost + a.acoustic_cost)
                beta[s] = logadd(beta[s], w + beta[a.nextstate])
        total = neg_inf
        for s, w in self.finals.items():
            total = logadd(total, alpha[s] - w)
        out = []
        for s in range(n):
            if alpha[s] == neg_inf:
                continue
            for a in self.arcs[s]:
                if not a.olabel:
                    continue
                w = -(a.graph_cost + a.acoustic_cost)
                post = math.exp(
                    min(alpha[s] + w + beta[a.nextstate] - total, 0.0)
                )
                out.append(
                    (a.olabel, post, self.state_frame[s],
                     self.state_frame[a.nextstate])
                )
        return out

    def best_path(self) -> Tuple[List[int], List[int], float]:
        """Viterbi over combined cost -> (ilabels, olabels, cost)
        (decoderbin/lattice-best-path.cc)."""
        n = self.num_states
        dist = np.full(n, INF)
        back: List[Optional[Tuple[int, LatticeArc]]] = [None] * n
        dist[self.start] = 0.0
        order = np.argsort(np.asarray(self.state_frame), kind="stable")
        for s in order:
            if not np.isfinite(dist[s]):
                continue
            for a in self.arcs[s]:
                nd = dist[s] + a.graph_cost + a.acoustic_cost
                if nd < dist[a.nextstate]:
                    dist[a.nextstate] = nd
                    back[a.nextstate] = (int(s), a)
        best_s, best_c = -1, INF
        for s, fw in self.finals.items():
            if dist[s] + fw < best_c:
                best_c = dist[s] + fw
                best_s = s
        if best_s < 0:
            return [], [], INF
        ils: List[int] = []
        ols: List[int] = []
        s = best_s
        while back[s] is not None:
            p, a = back[s]
            if a.ilabel:
                ils.append(a.ilabel)
            if a.olabel:
                ols.append(a.olabel)
            s = p
        ils.reverse()
        ols.reverse()
        return ils, ols, best_c

    def nbest(self, n: int) -> List[Tuple[List[int], float]]:
        """N shortest word paths (lattice-to-nbest semantics), by A*-free
        k-shortest-paths (heap of partial paths; lattices are small DAGs)."""
        results: List[Tuple[List[int], float]] = []
        # heap entries: (cost_so_far, counter, state, words)
        cnt = 0
        heap = [(0.0, cnt, self.start, [])]
        visits: Dict[int, int] = {}
        while heap and len(results) < n:
            cost, _, s, words = heapq.heappop(heap)
            visits[s] = visits.get(s, 0) + 1
            if visits[s] > n:
                continue
            if s in self.finals:
                results.append((words, cost + self.finals[s]))
            for a in self.arcs[s]:
                cnt += 1
                nw = words + ([a.olabel] if a.olabel else [])
                heapq.heappush(
                    heap,
                    (cost + a.graph_cost + a.acoustic_cost, cnt,
                     a.nextstate, nw),
                )
        return results

    def word_times(self) -> List[Tuple[int, int, int]]:
        """Best-path (word, start_frame, end_frame) triples for CTM output
        (nbest-to-ctm semantics: word boundaries at olabel frames)."""
        n = self.num_states
        dist = np.full(n, INF)
        back: List[Optional[Tuple[int, LatticeArc]]] = [None] * n
        dist[self.start] = 0.0
        order = np.argsort(np.asarray(self.state_frame), kind="stable")
        for s in order:
            if not np.isfinite(dist[s]):
                continue
            for a in self.arcs[s]:
                nd = dist[s] + a.graph_cost + a.acoustic_cost
                if nd < dist[a.nextstate]:
                    dist[a.nextstate] = nd
                    back[a.nextstate] = (int(s), a)
        best_s, best_c = -1, INF
        for s, fw in self.finals.items():
            if dist[s] + fw < best_c:
                best_c, best_s = dist[s] + fw, s
        out: List[Tuple[int, int, int]] = []
        if best_s < 0:
            return out
        s = best_s
        last_frame = self.state_frame[s]
        while back[s] is not None:
            p, a = back[s]
            if a.olabel:
                out.append((a.olabel, self.state_frame[p], last_frame))
                last_frame = self.state_frame[p]
            s = p
        out.reverse()
        return out

    def one_best(self) -> "Lattice":
        """Linear lattice containing only the best path, costs preserved
        per arc (= decoderbin/lattice-1best.cc)."""
        n = self.num_states
        dist = np.full(n, INF)
        back: List[Optional[Tuple[int, LatticeArc]]] = [None] * n
        dist[self.start] = 0.0
        order = np.argsort(np.asarray(self.state_frame), kind="stable")
        for s in order:
            if not np.isfinite(dist[s]):
                continue
            for a in self.arcs[s]:
                nd = dist[s] + a.graph_cost + a.acoustic_cost
                if nd < dist[a.nextstate]:
                    dist[a.nextstate] = nd
                    back[a.nextstate] = (int(s), a)
        best_s, best_c = -1, INF
        for s, fw in self.finals.items():
            if dist[s] + fw < best_c:
                best_c, best_s = dist[s] + fw, s
        out = Lattice()
        if best_s < 0:
            return out
        chain: List[Tuple[int, LatticeArc]] = []
        s = best_s
        while back[s] is not None:
            chain.append(back[s])
            s = back[s][0]
        chain.reverse()
        prev = out.add_state(self.state_frame[self.start])
        for src, a in chain:
            nxt = out.add_state(self.state_frame[a.nextstate])
            out.arcs[prev].append(dataclasses.replace(a, nextstate=nxt))
            prev = nxt
        out.finals[prev] = self.finals[best_s]
        return out


def lattice_from_beam(
    outputs: BeamOutputs,
    utt: int,
    length: int,
    graph: CompiledGraph,
    loglikes: np.ndarray,
    acoustic_scale: float,
    keep_tokens: int = 0,
    use_lat_mask: bool = False,
) -> Lattice:
    """Reconstruct the word lattice for one utterance from per-frame beam
    survivors by re-expanding graph arcs between them host-side.

    The resulting lattice contains every (token_t -> token_{t+1}) emitting
    arc plus intra-frame epsilon chains (eps closure is re-run between
    surviving tokens using the graph's eps arcs; closures that emit more
    than one word become chains of intermediate lattice states, one word
    per arc — full olabel fidelity).  Acoustic costs are stored SCALED by
    acoustic_scale, matching the in-search costs (the reference's
    GetRawLattice); unscale with lat.scale(1/acwt) before archiving, as
    decoder-wrappers.cc:100-107 does.

    Token retention: keep_tokens (0 = all K) truncates to the best few
    tokens per frame by in-search score.  use_lat_mask additionally
    drops tokens outside the in-search lattice beam (BeamOutputs
    .lat_mask) — OFF by default because that mask is a FRAME-LOCAL
    margin (score vs frame best), which is unsound for retention: a
    token can trail the frame best by more than lattice_beam mid-word
    yet lie on a complete path within lattice_beam of the best (weak
    words recovered via LM), and masking it collapses the lattice
    (measured: 3-4%% of flagship utterances lost their entire word
    sequence).  The reference prunes with complete forward+backward
    path costs instead (PruneActiveTokens) — our exact equivalent is
    Lattice.prune, run after reconstruction.
    """
    st = np.asarray(outputs.states)[:, utt]      # [T, K]
    sc = np.asarray(outputs.scores)[:, utt]
    par = np.asarray(outputs.parent)[:, utt]
    lmask = np.asarray(outputs.lat_mask)[:, utt]
    t_max, k = st.shape
    length = min(length, t_max)
    kk = keep_tokens or k

    # the Viterbi chain is ALWAYS retained: keep_tokens/lat_mask rank
    # tokens by frame-local score, and the global best path can rank
    # arbitrarily low mid-utterance (weak words recovered via the LM) —
    # truncating it silently deletes words (round-2g postmortem)
    chain = np.full(length, -1, np.int64)
    if length > 0:
        last = st[length - 1]
        fwts = np.asarray(graph.final_weight)
        fin = np.where(last >= 0, fwts[np.maximum(last, 0)], np.inf)
        tot = sc[length - 1] + fin
        cand = tot if np.isfinite(tot).any() else np.where(
            last >= 0, sc[length - 1], np.inf
        )
        j = int(np.argmin(cand))
        for t in range(length - 1, -1, -1):
            chain[t] = st[t, j]
            j = int(par[t, j])

    lat = Lattice()
    # initial state (frame -1)
    init_id = lat.add_state(-1)
    lat.start = init_id

    ids: List[Dict[int, int]] = []
    for t in range(length):
        order = np.argsort(sc[t])[:kk]
        d: Dict[int, int] = {}
        if chain[t] >= 0:
            d[int(chain[t])] = lat.add_state(t)
        for j in order:
            s = int(st[t, j])
            if s < 0 or not np.isfinite(sc[t, j]):
                continue
            if use_lat_mask and not lmask[t, j]:
                continue
            if s not in d:
                d[s] = lat.add_state(t)
        ids.append(d)

    # eps closure helper over graph eps arcs from a set of (state, cost)
    eo, ew, ed, eol = (
        graph.eps_offsets, graph.eps_weight, graph.eps_dst, graph.eps_olabel,
    )

    _reach_cache: Dict[int, List[Tuple[int, float, Tuple[int, ...]]]] = {}

    def eps_reach(src_state: int) -> List[Tuple[int, float, Tuple[int, ...]]]:
        """(reachable_state, eps_cost, olabel_sequence) via eps arcs
        (depth bounded).  The full word sequence along the closure path
        is kept (multi-word chains become chained lattice arcs below).
        Cached per graph state — the same states recur every frame, so
        the reconstruction is O(touched-states*closure), not
        O(T*K*closure)."""
        hit = _reach_cache.get(src_state)
        if hit is not None:
            return hit
        out = [(src_state, 0.0, ())]
        frontier = [(src_state, 0.0, ())]
        for _ in range(graph.eps_depth):
            nxt = []
            for s, c, ols in frontier:
                for e in range(int(eo[s]), int(eo[s + 1])):
                    o = int(eol[e])
                    nols = ols + ((o,) if o else ())
                    nxt.append((int(ed[e]), c + float(ew[e]), nols))
            out.extend(nxt)
            frontier = nxt
            if not frontier:
                break
        _reach_cache[src_state] = out
        return out

    v = loglikes.shape[1]
    o_em, w_em, d_em, il_em, ol_em = (
        graph.emit_offsets, graph.emit_weight, graph.emit_dst,
        graph.emit_ilabel, graph.emit_olabel,
    )

    def add_chain(
        lat_src: int, il: int, ols: Tuple[int, ...],
        gc: float, ac: float, dst_lat: int, frame: int,
    ) -> None:
        """One lattice arc per word: >1 word in an arc's eps closure
        becomes a chain of intermediate states (the reference's raw
        lattices carry them as separate ForwardLinks too).  Intermediate
        states take the SOURCE frame so the stable frame-sort used by
        best_path/prune stays topological."""
        first_ol = ols[0] if ols else 0
        rest = ols[1:] if ols else ()
        if not rest:
            lat.arcs[lat_src].append(
                LatticeArc(il, first_ol, gc, ac, dst_lat)
            )
            return
        cur = lat.add_state(frame)
        lat.arcs[lat_src].append(LatticeArc(il, first_ol, gc, ac, cur))
        for i, o in enumerate(rest):
            last = i == len(rest) - 1
            nxt = dst_lat if last else lat.add_state(frame)
            lat.arcs[cur].append(LatticeArc(0, o, 0.0, 0.0, nxt))
            cur = nxt

    def expand_from(
        lat_src: int, g_state: int, base_cost: float, t: int,
        prefix_ols: Tuple[int, ...] = (),
    ):
        """All emitting arcs (+eps closure) from g_state into frame t's
        survivors."""
        for e in range(int(o_em[g_state]), int(o_em[g_state + 1])):
            il = int(il_em[e])
            ac = -acoustic_scale * float(loglikes[t, il - 1])
            gc = float(w_em[e]) + base_cost
            mid = int(d_em[e])
            arc_ol = int(ol_em[e])
            for (rs, ec, eols) in eps_reach(mid):
                if rs in ids[t]:
                    ols = prefix_ols + ((arc_ol,) if arc_ol else ()) + eols
                    add_chain(
                        lat_src, il, ols, gc + ec, ac, ids[t][rs],
                        t - 1 if t > 0 else -1,
                    )

    # frame 0: from the start state's closure (closure words included)
    for (rs, ec, eols) in eps_reach(graph.start):
        expand_from(init_id, rs, ec, 0, prefix_ols=eols)
    # frames t-1 -> t
    for t in range(1, length):
        for s, lid in ids[t - 1].items():
            expand_from(lid, s, 0.0, t)

    # finals at the last frame
    for s, lid in ids[length - 1].items():
        fw = float(graph.final_weight[s])
        if np.isfinite(fw):
            lat.finals[lid] = fw
    if not lat.finals:  # partial-path fallback
        best = min(ids[length - 1].values(), default=None)
        if best is not None:
            lat.finals[best] = 0.0
    return lat
