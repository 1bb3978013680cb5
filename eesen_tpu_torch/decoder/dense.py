"""Dense (beam-free) Viterbi decoding over the full TLG trellis
(counterpart of eesen_tpu/decoder/dense.py).

The reference's best-path decoder (src/decoder/faster-decoder.cc) walks a
hash-map of active tokens.  The batched beam search (decoder/beam.py)
replaces the hash map with a K-slot active set; this module takes the
other limit: keep the score of EVERY graph state as a dense [B, N] tensor
and relax all arcs every frame with gathers and minima: no sort, no
top-k, no beam.  It is full Viterbi, equivalent to an infinite beam:

- arcs are stored by DESTINATION (in-CSR) padded to a fixed in-degree D,
  so each frame's emitting relaxation is one gather of [B, N, D]
  candidates and one minimum over D;
- states with in-degree > D ("in-hubs": LM backoff targets, word-start
  states) keep their in-arcs in a dense padded [H, Dh] side table reduced
  the same way — skew never forces a bigger D;
- epsilon chains use the precomputed transitive closure (same tables as
  the beam decoder), inverted to in-CSR + in-hubs, so one closure
  relaxation per frame suffices;
- per-frame winning-arc ids are stored as compact uint8 slot indices
  ([T, B, N] u8 for both phases); the best path is recovered on the host
  by walking them backwards (traceback_dense).

The graph build and the traceback are host numpy, copied from the JAX
package.  The decode is a Python loop over frames of torch ops on the
device of the DenseDeviceGraph (the JAX package's `lax.scan`); no kernel,
since the JAX version is XLA code.  A minimum over the D slots takes the
first minimal slot, as the JAX package's loop of strict `<` updates does.
Eager torch compiles nothing, so the JAX package's decoder cache in
`decode_dense` has no counterpart.

Reference semantics matched: tid-1 acoustic column shift
(src/decoder/decodable-matrix.h:47-54), final-weight selection with
partial-path fallback (src/decoder/decoder-wrappers.cc:60).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from eesen_tpu_torch.decoder.beam import _np
from eesen_tpu_torch.decoder.graph_compile import CompiledGraph
from eesen_tpu_torch.models.model import as_tensor, check_device

F32_INF = np.float32(np.inf)
STAY = 254     # closure slot: the state kept its own score
HUB = 255      # slot resolved through the hub tables


@dataclasses.dataclass
class DenseGraph:
    """In-CSR arc tables for dense relaxation.  Host-side numpy."""
    num_states: int
    start: int
    # regular states: padded [N, D] in-arc tables (slot-padded with
    # src=0, w=+inf so padded slots never win)
    emit_src: np.ndarray      # [N, D] int32
    emit_w: np.ndarray        # [N, D] float32
    emit_il: np.ndarray      # [N, D] int32 (token id; acoustic col = id-1)
    emit_ol: np.ndarray      # [N, D] int32
    # in-hub states: contiguous padded [He, Dh] tables + their state ids
    ehub_state: np.ndarray    # [He] int32
    ehub_src: np.ndarray      # [He, Dh] int32
    ehub_w: np.ndarray        # [He, Dh] float32
    ehub_il: np.ndarray       # [He, Dh] int32
    ehub_ol: np.ndarray       # [He, Dh] int32
    # closure (epsilon) in-tables, same structure
    clo_src: np.ndarray       # [N, Dc] int32
    clo_w: np.ndarray         # [N, Dc] float32
    clo_ol: np.ndarray        # [N, Dc] int32
    chub_state: np.ndarray    # [Hc] int32
    chub_src: np.ndarray      # [Hc, Dch] int32
    chub_w: np.ndarray        # [Hc, Dch] float32
    chub_ol: np.ndarray       # [Hc, Dch] int32
    final_weight: np.ndarray  # [N] float32
    # initial scores after the start state's eps closure
    init_score: np.ndarray    # [N] float32
    init_olabel: np.ndarray   # [N] int32 (word emitted on the init closure)


def _invert_to_in_tables(
    offsets: np.ndarray, src_of_arc: np.ndarray, w: np.ndarray,
    il: Optional[np.ndarray], ol: np.ndarray, dst: np.ndarray,
    n: int, cap: int,
) -> Tuple[np.ndarray, ...]:
    """CSR-by-source -> padded in-CSR by destination + hub side tables."""
    order = np.argsort(dst, kind="stable")
    dsts = dst[order]
    counts = np.bincount(dsts, minlength=n)
    # positions of each arc within its destination's in-list
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(dsts), dtype=np.int64) - starts[dsts]

    hub_mask_state = counts > cap
    hub_states = np.nonzero(hub_mask_state)[0].astype(np.int32)
    is_hub_arc = hub_mask_state[dsts]

    # regular padded table
    reg = ~is_hub_arc
    eil = il[order] if il is not None else np.zeros(len(dsts), np.int32)
    tbl_src = np.zeros((n, cap), np.int32)
    tbl_w = np.full((n, cap), F32_INF, np.float32)
    tbl_il = np.zeros((n, cap), np.int32)
    tbl_ol = np.zeros((n, cap), np.int32)
    r_d, r_p = dsts[reg], pos[reg]
    tbl_src[r_d, r_p] = src_of_arc[order][reg]
    tbl_w[r_d, r_p] = w[order][reg]
    tbl_il[r_d, r_p] = eil[reg]
    tbl_ol[r_d, r_p] = ol[order][reg]

    # hub side tables
    h = len(hub_states)
    dh = int(counts[hub_states].max()) if h else 1
    hub_src = np.zeros((h, dh), np.int32)
    hub_w = np.full((h, dh), F32_INF, np.float32)
    hub_il = np.zeros((h, dh), np.int32)
    hub_ol = np.zeros((h, dh), np.int32)
    if h:
        hub_row = np.full(n, -1, np.int64)
        hub_row[hub_states] = np.arange(h)
        h_d, h_p = hub_row[dsts[is_hub_arc]], pos[is_hub_arc]
        hub_src[h_d, h_p] = src_of_arc[order][is_hub_arc]
        hub_w[h_d, h_p] = w[order][is_hub_arc]
        hub_il[h_d, h_p] = eil[is_hub_arc]
        hub_ol[h_d, h_p] = ol[order][is_hub_arc]
    return (tbl_src, tbl_w, tbl_il, tbl_ol,
            hub_states, hub_src, hub_w, hub_il, hub_ol)


def build_dense_graph(
    g: CompiledGraph, in_degree: int = 16, closure_in_degree: int = 16,
) -> DenseGraph:
    """Invert a CompiledGraph (with closure tables) into dense in-CSR form.

    The forward degree cap / aux states of `g` are irrelevant here (we use
    its raw arc lists); what matters is the IN-degree distribution, handled
    by the cap + hub split."""
    assert g.has_closure, "dense decode needs compile_graph(build_closure=True)"
    n = g.num_states

    src_of_emit = np.repeat(
        np.arange(n, dtype=np.int32),
        (g.emit_offsets[1:] - g.emit_offsets[:-1]).astype(np.int64),
    )
    (e_src, e_w, e_il, e_ol, eh_state, eh_src, eh_w, eh_il, eh_ol
     ) = _invert_to_in_tables(
        g.emit_offsets, src_of_emit, g.emit_weight, g.emit_ilabel,
        g.emit_olabel, g.emit_dst, n, in_degree,
    )

    co = g.closure_offsets
    cp = g.closure_packed
    src_of_clo = np.repeat(
        np.arange(n, dtype=np.int32), (co[1:] - co[:-1]).astype(np.int64)
    )
    c_w_all = cp[:, 2].view(np.float32).copy() if len(cp) else np.zeros(0, np.float32)
    (c_src, c_w, _, c_ol, ch_state, ch_src, ch_w, _, ch_ol
     ) = _invert_to_in_tables(
        co, src_of_clo, c_w_all,
        None, cp[:, 1] if len(cp) else np.zeros(0, np.int32),
        cp[:, 3] if len(cp) else np.zeros(0, np.int32), n, closure_in_degree,
    )

    # initial scores: start state + its closure
    init = np.full(n, F32_INF, np.float32)
    init_ol = np.zeros(n, np.int32)
    init[g.start] = 0.0
    for k in range(co[g.start], co[g.start + 1]):
        d = int(cp[k, 3])
        w = float(np.int32(cp[k, 2]).view(np.float32))
        if w < init[d]:
            init[d] = w
            init_ol[d] = int(cp[k, 1])
    return DenseGraph(
        num_states=n, start=g.start,
        emit_src=e_src, emit_w=e_w, emit_il=e_il, emit_ol=e_ol,
        ehub_state=eh_state, ehub_src=eh_src, ehub_w=eh_w,
        ehub_il=eh_il, ehub_ol=eh_ol,
        clo_src=c_src, clo_w=c_w, clo_ol=c_ol,
        chub_state=ch_state, chub_src=ch_src, chub_w=ch_w, chub_ol=ch_ol,
        final_weight=g.final_weight.copy(),
        init_score=init, init_olabel=init_ol,
    )


class DenseDeviceGraph(NamedTuple):
    """The DenseGraph tables the decode reads, as tensors on one device
    (index tables int64, weights float32)."""
    emit_src: torch.Tensor
    emit_w: torch.Tensor
    emit_il: torch.Tensor
    ehub_state: torch.Tensor
    ehub_src: torch.Tensor
    ehub_w: torch.Tensor
    ehub_il: torch.Tensor
    clo_src: torch.Tensor
    clo_w: torch.Tensor
    chub_state: torch.Tensor
    chub_src: torch.Tensor
    chub_w: torch.Tensor
    init_score: torch.Tensor

    @classmethod
    def put(cls, g: DenseGraph, device="cuda") -> "DenseDeviceGraph":
        device = check_device(device)

        def idx(a):
            return torch.from_numpy(a.astype(np.int64)).to(device)

        def f32(a):
            return torch.from_numpy(a.astype(np.float32)).to(device)

        return cls(
            idx(g.emit_src), f32(g.emit_w), idx(g.emit_il),
            idx(g.ehub_state), idx(g.ehub_src), f32(g.ehub_w),
            idx(g.ehub_il),
            idx(g.clo_src), f32(g.clo_w),
            idx(g.chub_state), idx(g.chub_src), f32(g.chub_w),
            f32(g.init_score),
        )


class DenseOutputs(NamedTuple):
    emit_arg: torch.Tensor   # [T, B, N] uint8 winning emit in-slot (255 =
    #                          hub row resolved via hub tables on the host)
    clo_arg: torch.Tensor    # [T, B, N] uint8 winning closure in-slot (254
    #                          = stay)
    ehub_arg: torch.Tensor   # [T, B, He] int32 winning hub slot
    chub_arg: torch.Tensor   # [T, B, Hc] int32
    final_scores: torch.Tensor  # [B, N] float32 post-closure scores at each
    #                             utterance's LAST frame (lengths-aware)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, M] gathered along dim 1 by an index table idx [R, D] ->
    [B, R, D]."""
    return torch.index_select(x, 1, idx.reshape(-1)).view(
        x.shape[0], *idx.shape)


def make_dense_decoder(
    dg_host: DenseGraph, acoustic_scale: float = 0.9,
):
    """Build a dense Viterbi decoder:
    fn(loglikes [B,T,V], lengths [B], dev_graph) -> DenseOutputs on the
    device of dev_graph."""
    n = dg_host.num_states
    d_in = dg_host.emit_src.shape[1]
    dc_in = dg_host.clo_src.shape[1]
    assert d_in < STAY and dc_in < STAY, "in-degree caps clash with sentinels"
    he = len(dg_host.ehub_state)
    hc = len(dg_host.chub_state)
    scale = acoustic_scale

    def relax_emit(sc, ll_s, cols, dg: DenseDeviceGraph):
        # candidates sc[src] + w - scale * ll[il - 1] per in-slot; the
        # acoustic term was scaled once per call (ll_s)
        e_col, h_col = cols
        cand = _gather(sc, dg.emit_src) + dg.emit_w[None] \
            - _gather(ll_s, e_col)
        best, arg = torch.min(cand, dim=2)
        arg = arg.to(torch.uint8)
        if he:
            cand = _gather(sc, dg.ehub_src) + dg.ehub_w[None] \
                - _gather(ll_s, h_col)                           # [B,He,Dh]
            hub_best, hub_arg = torch.min(cand, dim=2)
            cur = best[:, dg.ehub_state]
            use = hub_best < cur
            best[:, dg.ehub_state] = torch.where(use, hub_best, cur)
            arg[:, dg.ehub_state] = torch.where(
                use, HUB, arg[:, dg.ehub_state]).to(torch.uint8)
            hub_arg = hub_arg.to(torch.int32)
        else:
            hub_arg = torch.zeros((sc.shape[0], 0), dtype=torch.int32,
                                  device=sc.device)
        return best, arg, hub_arg

    def relax_closure(sc, dg: DenseDeviceGraph):
        cand = _gather(sc, dg.clo_src) + dg.clo_w[None]
        m, a = torch.min(cand, dim=2)
        take = m < sc
        best = torch.where(take, m, sc)
        arg = torch.where(take, a, STAY).to(torch.uint8)
        if hc:
            cand = _gather(sc, dg.chub_src) + dg.chub_w[None]   # [B,Hc,Dch]
            hub_best, hub_arg = torch.min(cand, dim=2)
            cur = best[:, dg.chub_state]
            use = hub_best < cur
            best[:, dg.chub_state] = torch.where(use, hub_best, cur)
            arg[:, dg.chub_state] = torch.where(
                use, HUB, arg[:, dg.chub_state]).to(torch.uint8)
            hub_arg = hub_arg.to(torch.int32)
        else:
            hub_arg = torch.zeros((sc.shape[0], 0), dtype=torch.int32,
                                  device=sc.device)
        return best, arg, hub_arg

    def decode(loglikes, lengths, dg: DenseDeviceGraph) -> DenseOutputs:
        dev = dg.init_score.device
        ll = as_tensor(loglikes, torch.float32).to(dev)
        lens = as_tensor(lengths, torch.int64).to(dev)
        b, t_max, v = ll.shape
        ll_s = scale * ll
        cols = (torch.clamp(dg.emit_il - 1, 0, v - 1),
                torch.clamp(dg.ehub_il - 1, 0, v - 1))
        sc = dg.init_score[None].expand(b, n)
        fin = sc  # zero-length utterances keep the init scores
        e_args = torch.empty((t_max, b, n), dtype=torch.uint8, device=dev)
        c_args = torch.empty((t_max, b, n), dtype=torch.uint8, device=dev)
        eh_args = torch.empty((t_max, b, he), dtype=torch.int32, device=dev)
        ch_args = torch.empty((t_max, b, hc), dtype=torch.int32, device=dev)
        for t in range(t_max):
            e_best, e_args[t], eh_args[t] = relax_emit(
                sc, ll_s[:, t], cols, dg)
            c_best, c_args[t], ch_args[t] = relax_closure(e_best, dg)
            sc = torch.where((t < lens)[:, None], c_best, sc)
            fin = torch.where((t == lens - 1)[:, None], c_best, fin)
        return DenseOutputs(e_args, c_args, eh_args, ch_args, fin)

    return decode


def traceback_dense(
    out: DenseOutputs,
    final_scores: np.ndarray,     # [B, N] post-closure scores at each
    #                               utterance's LAST frame
    lengths: np.ndarray,
    g: DenseGraph,
) -> List[Tuple[List[int], float]]:
    """Host walk of the winning-slot tables; returns (words, cost) per utt."""
    e_arg = _np(out.emit_arg)
    c_arg = _np(out.clo_arg)
    eh_arg = _np(out.ehub_arg)
    ch_arg = _np(out.chub_arg)
    final_scores = _np(final_scores)
    lengths = _np(lengths)
    he_row = {int(s): i for i, s in enumerate(g.ehub_state)}
    hc_row = {int(s): i for i, s in enumerate(g.chub_state)}
    results = []
    b = final_scores.shape[0]
    for i in range(b):
        t_last = int(lengths[i]) - 1
        if t_last < 0:
            results.append(([], 0.0))
            continue
        total = final_scores[i] + g.final_weight
        if np.isfinite(total).any():
            s = int(np.argmin(total))
            cost = float(total[s])
        else:
            s = int(np.argmin(final_scores[i]))
            cost = float(final_scores[i][s])
        words_rev: List[int] = []
        for t in range(t_last, -1, -1):
            # closure phase (post-emit) at frame t
            ca = int(c_arg[t, i, s])
            if ca == HUB and s in hc_row:
                hslot = int(ch_arg[t, i, hc_row[s]])
                ol = int(g.chub_ol[hc_row[s], hslot])
                src = int(g.chub_src[hc_row[s], hslot])
            elif ca == STAY:
                ol, src = 0, s
            else:
                ol = int(g.clo_ol[s, ca])
                src = int(g.clo_src[s, ca])
            if ol:
                words_rev.append(ol)
            s = src
            # emit phase at frame t
            ea = int(e_arg[t, i, s])
            if ea == HUB and s in he_row:
                hslot = int(eh_arg[t, i, he_row[s]])
                ol = int(g.ehub_ol[he_row[s], hslot])
                src = int(g.ehub_src[he_row[s], hslot])
            else:
                ol = int(g.emit_ol[s, ea])
                src = int(g.emit_src[s, ea])
            if ol:
                words_rev.append(ol)
            s = src
        if int(g.init_olabel[s]):
            words_rev.append(int(g.init_olabel[s]))
        results.append((words_rev[::-1], cost))
    return results


def decode_dense(
    loglikes: np.ndarray, lengths: np.ndarray,
    g: DenseGraph, dev: DenseDeviceGraph,
    acoustic_scale: float = 0.9,
) -> List[Tuple[List[int], float]]:
    """Convenience one-call dense decode: device pass + host traceback
    (the device tables come to the host once)."""
    out = make_dense_decoder(g, acoustic_scale)(loglikes, lengths, dev)
    return traceback_dense(out, out.final_scores, lengths, g)
