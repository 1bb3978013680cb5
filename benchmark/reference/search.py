"""Plain reference of the decode path: blank-skip compaction and the
token-passing WFST beam search, in numpy and torch ops.

Compaction (phone-synchronous decoding, Chen et al., Interspeech 2016):
within each utterance's first n frames a frame is blank-dominated when
its blank log-posterior is at least log(threshold); each run of such
frames is merged into its last frame, whose column c becomes

    sum over the run of ll[blank] + max over the run of (ll[c] - ll[blank])

(summed in float64 here), and every other frame is kept as it is, in
order.

The search is Kaldi's faster-decoder token passing over the TLG
(src/decoder/faster-decoder.cc), with the port's pruning rules: K slots a
row; a frame expands every live slot's emitting arcs (one block of the
widest degree a slot, slot by slot) with score
prev + weight - acwt * ll[t, ilabel - 1], keeps the best proposal per
destination state (ties to the earliest lane), drops proposals worse
than the best by more than `beam`, and keeps the K best; then the
epsilon closure (one expansion of the precomputed transitive closure,
its lanes after the emitted set's own, merged by the same rule).  Ties
among the K best go by one of two rules, `ties`: to the earlier lane
("lane", the order of the port's kernel 2) or to the lower state id
("state", the order of its sort route).  Which rule a merge of the
program takes follows a detail of the program (kernel 2's width), so
the cell compares the program with both and takes the nearer: the check
does not move when that width does.  The graph is read from the cached `.npz`
arrays and laid out here again.  The best path ends in the final state
of least score + final weight, or, where no final state survives, in the
best state; its words are the output labels along its backpointers.

`word_costs` is the same search restricted to the paths that output
given words (tokens are (state, words so far) pairs, a wide beam): the
least cost at which each utterance's frames say those words.

`prec` = "bf16" rounds the log-likelihoods and every score to bfloat16:
the control (reference/quant.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference.quant import rnd

INF = float("inf")


def compact(ll: np.ndarray, n: int, threshold: float, prec: str = "f32"
            ) -> np.ndarray:
    """ll [T, V] log-posteriors of one utterance, n its length -> the kept
    frames [n', V] float32."""
    x = ll[:n].astype(np.float64)
    if prec == "bf16":
        x = rnd(torch.from_numpy(x).float(), prec).double().numpy()
    blank = x[:, 0]
    bd = blank >= math.log(threshold)
    out = []
    start = 0                       # first frame of the current segment
    for t in range(n):
        tail = bd[t] and (t + 1 == n or not bd[t + 1])
        if bd[t] and not tail:
            continue
        seg = slice(start, t + 1)
        out.append(blank[seg].sum() + (x[seg] - blank[seg, None]).max(0))
        start = t + 1
    res = np.asarray(out, np.float32).reshape(len(out), x.shape[1])
    if prec == "bf16":
        res = rnd(torch.from_numpy(res), prec).numpy()
    return res


class Graph:
    """The TLG's emitting and closure arcs as CSR tensors on `device`."""

    def __init__(self, npz_path: str, device):
        z = np.load(npz_path)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self.start = int(z["start"])
        self.final = t(z["final_weight"].astype(np.float32))
        self.e_off = t(z["emit_offsets"].astype(np.int64))
        self.e_il = t(z["emit_ilabel"].astype(np.int64))
        self.e_ol = t(z["emit_olabel"].astype(np.int64))
        self.e_w = t(z["emit_weight"].astype(np.float32))
        self.e_dst = t(z["emit_dst"].astype(np.int64))
        cp = z["closure_packed"]
        self.x_off = t(z["closure_offsets"].astype(np.int64))
        self.x_ol = t(cp[:, 1].astype(np.int64))
        self.x_w = t(cp[:, 2].view(np.float32).copy())
        self.x_dst = t(cp[:, 3].astype(np.int64))
        self.e_deg = int(np.diff(z["emit_offsets"]).max())
        self.x_deg = max(int(np.diff(z["closure_offsets"]).max()), 1)


def _expand(states, scores, off, dmax):
    """Arc ids [B, K*D] of each live slot's arcs (one block of dmax a
    slot), the lanes' source slots and validity."""
    b, k = states.shape
    live = states >= 0
    s = states.clamp(min=0)
    base = off[s]
    deg = torch.where(live, off[s + 1] - base, torch.zeros_like(base))
    j = torch.arange(dmax, device=states.device)
    ok = (j < deg[..., None]) & torch.isfinite(scores)[..., None]
    aid = torch.where(ok, base[..., None] + j, torch.zeros_like(base[..., None]))
    src = torch.arange(k, device=states.device)[:, None].expand(k, dmax)
    return (aid.reshape(b, k * dmax), ok.reshape(b, k * dmax),
            src.reshape(1, k * dmax).expand(b, k * dmax))


def _merge(dst, score, k: int, beam: float, ties: str = "state"):
    """Best proposal per destination, beam, K best -> (states [B, K]
    (-1 dead), scores [B, K], lane index [B, K]); equal scores go to the
    earlier lane (ties "lane") or to the lower state id ("state")."""
    best = score.min(dim=1, keepdim=True).values
    score = torch.where(score <= best + beam, score,
                        torch.full_like(score, INF))
    o1 = torch.sort(score, dim=1, stable=True).indices
    o2 = torch.sort(dst.gather(1, o1), dim=1, stable=True).indices
    order = o1.gather(1, o2)
    d2 = dst.gather(1, order)
    s2 = score.gather(1, order)
    first = torch.ones_like(d2, dtype=torch.bool)
    first[:, 1:] = d2[:, 1:] != d2[:, :-1]
    s2 = torch.where(first, s2, torch.full_like(s2, INF))
    if ties == "lane":
        # the winners back in lane order
        d2, s2 = dst, torch.empty_like(s2).scatter_(1, order, s2)
        order = torch.arange(dst.shape[1], device=dst.device).expand_as(dst)
    if s2.shape[1] < k:
        pad = k - s2.shape[1]
        s2 = torch.cat([s2, torch.full_like(s2[:, :pad], INF)], 1)
        d2 = torch.cat([d2, torch.zeros_like(d2[:, :pad])], 1)
        order = torch.cat([order, torch.zeros_like(order[:, :pad])], 1)
    top = torch.sort(s2, dim=1, stable=True).indices[:, :k]
    sc = s2.gather(1, top)
    st = torch.where(torch.isfinite(sc), d2.gather(1, top),
                     torch.full_like(top, -1))
    return st, sc, order.gather(1, top)


def _closure(g: Graph, st, sc, parent, ol1, k, beam, prec, ties):
    """The epsilon closure of the set (st, sc), merged with it."""
    aid, ok, src = _expand(st, sc, g.x_off, g.x_deg)
    c_dst = torch.where(ok, g.x_dst[aid], torch.zeros_like(aid))
    c_sc = torch.where(ok, rnd(sc.gather(1, src) + g.x_w[aid], prec),
                       torch.full(aid.shape, INF, device=aid.device))
    c_ol = torch.where(ok, g.x_ol[aid], torch.zeros_like(aid))
    all_dst = torch.cat([st.clamp(min=0), c_dst], 1)
    all_sc = torch.cat([sc, c_sc], 1)
    all_par = torch.cat([parent, parent.gather(1, src)], 1)
    all_ol1 = torch.cat([ol1, ol1.gather(1, src)], 1)
    all_ol2 = torch.cat([torch.zeros_like(ol1), c_ol], 1)
    st2, sc2, idx = _merge(all_dst, all_sc, k, beam, ties)
    return (st2, sc2, all_par.gather(1, idx), all_ol1.gather(1, idx),
            all_ol2.gather(1, idx))


def search(g: Graph, lls: List[np.ndarray], cfg: Dict, prec: str = "f32",
           device="cuda", ties: str = "state"
           ) -> List[Tuple[List[int], float]]:
    """Best path (word ids, cost) of each utterance's compacted frames
    lls[i] [n_i, V], ties broken by `ties` ("lane" or "state")."""
    k, beam, acwt = cfg["max_active"], float(cfg["beam"]), \
        float(cfg["acoustic_scale"])
    b = len(lls)
    t_max = max(len(x) for x in lls)
    v = lls[0].shape[1]
    ll = np.zeros((b, max(t_max, 1), v), np.float32)
    for i, x in enumerate(lls):
        ll[i, :len(x)] = x
    ll = rnd(torch.from_numpy(ll).to(device), prec)
    lens = torch.tensor([len(x) for x in lls], device=device)
    st = torch.full((b, k), -1, dtype=torch.long, device=device)
    st[:, 0] = g.start
    sc = torch.full((b, k), INF, device=device)
    sc[:, 0] = 0.0
    ident = torch.arange(k, device=device).expand(b, k)
    zero = torch.zeros((b, k), dtype=torch.long, device=device)
    st, sc, _, _, init_ol = _closure(g, st, sc, ident, zero, k, beam, prec,
                                     ties)
    parents, olabs = [], []
    for t in range(t_max):
        aid, ok, src = _expand(st, sc, g.e_off, g.e_deg)
        e_dst = torch.where(ok, g.e_dst[aid], torch.zeros_like(aid))
        col = (g.e_il[aid] - 1).clamp(min=0)
        ac = rnd(-acwt * ll[:, t].gather(1, col), prec)
        e_sc = torch.where(ok, rnd(rnd(sc.gather(1, src) + g.e_w[aid], prec)
                                   + ac, prec),
                           torch.full(aid.shape, INF, device=device))
        e_ol = torch.where(ok, g.e_ol[aid], torch.zeros_like(aid))
        n_st, n_sc, idx = _merge(e_dst, e_sc, k, beam, ties)
        par = src.gather(1, idx)
        ol1 = torch.where(torch.isfinite(n_sc), e_ol.gather(1, idx), zero)
        n_st, n_sc, par, ol1, ol2 = _closure(g, n_st, n_sc, par, ol1, k,
                                            beam, prec, ties)
        act = (t < lens)[:, None]
        st = torch.where(act, n_st, st)
        sc = torch.where(act, n_sc, sc)
        parents.append(torch.where(act, par, ident))
        olabs.append(torch.stack([torch.where(act, ol1, zero),
                                  torch.where(act, ol2, zero)], -1))
    par = torch.stack(parents).cpu().numpy() if parents else None
    ols = torch.stack(olabs).cpu().numpy() if olabs else None
    st_h, sc_h = st.cpu().numpy(), sc.cpu().numpy()
    fin = g.final.cpu().numpy()
    init_h = init_ol.cpu().numpy()
    out = []
    for i in range(b):
        valid = st_h[i] >= 0
        total = np.where(valid, sc_h[i] + fin[np.maximum(st_h[i], 0)], INF)
        if np.isfinite(total).any():
            j = int(np.argmin(total))
            cost = float(total[j])
        else:
            s = np.where(valid, sc_h[i], INF)
            j = int(np.argmin(s))
            cost = float(s[j])
        rev = []
        for t in range(len(lls[i]) - 1, -1, -1):
            for w in ols[t, i, j][::-1]:
                if w:
                    rev.append(int(w))
            j = int(par[t, i, j])
        if init_h[i, j]:
            rev.append(int(init_h[i, j]))
        out.append((rev[::-1], cost))
    return out


def word_costs(g: Graph, lls: List[np.ndarray], words: List[List[int]],
               cfg: Dict, beam: float = 60.0, device="cuda") -> List[float]:
    """The least cost of each utterance's frames over the paths whose
    output labels are words[i], with four times the search's slots (at
    most 4096) and a beam of 60: with the final weight, or, where no such
    path ends in a final state, without it (as `search` falls back); inf
    where no path says those words."""
    acwt = float(cfg["acoustic_scale"])
    k = min(4 * cfg["max_active"], 4096)
    b = len(lls)
    t_max = max(len(x) for x in lls)
    v = lls[0].shape[1]
    ll = np.zeros((b, max(t_max, 1), v), np.float32)
    for i, x in enumerate(lls):
        ll[i, :len(x)] = x
    ll = torch.from_numpy(ll).to(device)
    lens = torch.tensor([len(x) for x in lls], device=device)
    nw = max(len(w) for w in words)
    wtab = torch.full((b, nw + 1), -1, dtype=torch.long, device=device)
    for i, w in enumerate(words):
        if w:
            wtab[i, :len(w)] = torch.tensor(w, device=device)
    n_words = torch.tensor([len(w) for w in words], device=device)
    span = nw + 2

    def step(st, pos, sc, off, dst_t, ol_t, w_t, dmax, extra=None):
        aid, ok, src = _expand(st, sc, off, dmax)
        p = pos.gather(1, src)
        ol = ol_t[aid]
        want = wtab.gather(1, p.clamp(max=nw))
        ok = ok & ((ol == 0) | (ol == want))
        n_pos = p + (ol != 0).long()
        n_sc = torch.where(ok, sc.gather(1, src) + w_t[aid]
                           + (0.0 if extra is None else extra(aid)),
                           torch.full(aid.shape, INF, device=device))
        n_st = torch.where(ok, dst_t[aid], torch.zeros_like(aid))
        return n_st, n_pos, n_sc

    def merge(st, pos, sc):
        key = st.clamp(min=0) * span + pos
        kst, ksc, idx = _merge(key, sc, k, beam)
        return (torch.where(kst >= 0, kst // span, -1),
                torch.where(kst >= 0, kst % span, 0), ksc)

    def closure(st, pos, sc):
        c_st, c_pos, c_sc = step(st, pos, sc, g.x_off, g.x_dst, g.x_ol,
                                 g.x_w, g.x_deg)
        return merge(torch.cat([st, c_st], 1), torch.cat([pos, c_pos], 1),
                     torch.cat([sc, c_sc], 1))

    st = torch.full((b, k), -1, dtype=torch.long, device=device)
    st[:, 0] = g.start
    pos = torch.zeros((b, k), dtype=torch.long, device=device)
    sc = torch.full((b, k), INF, device=device)
    sc[:, 0] = 0.0
    st, pos, sc = closure(st, pos, sc)
    for t in range(t_max):
        acoustic = lambda aid: -acwt * ll[:, t].gather(
            1, (g.e_il[aid] - 1).clamp(min=0))
        e = step(st, pos, sc, g.e_off, g.e_dst, g.e_ol, g.e_w, g.e_deg,
                 acoustic)
        n_st, n_pos, n_sc = closure(*merge(*e))
        act = (t < lens)[:, None]
        st = torch.where(act, n_st, st)
        pos = torch.where(act, n_pos, pos)
        sc = torch.where(act, n_sc, sc)
    done = (st >= 0) & (pos == n_words[:, None])
    inf = torch.full_like(sc, INF)
    final = torch.where(done, sc + g.final[st.clamp(min=0)], inf).min(1)
    partial = torch.where(done, sc, inf).min(1)   # no final state left
    return [float(f if f < INF else p) for f, p in
            zip(final.values.cpu(), partial.values.cpu())]
