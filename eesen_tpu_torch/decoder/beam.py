"""Batched token-passing WFST beam search in PyTorch (counterpart of
eesen_tpu/decoder/beam.py).

The batched replacement for the reference's CPU Viterbi decoders
(src/decoder/faster-decoder.cc ProcessEmitting/ProcessNonemitting token
passing with beam + max_active pruning; src/decoder/decodable-matrix.h
tid-1 acoustic column shift), with static shapes:

- The active set is K slots per utterance ([B, K] state ids + scores;
  dead slots = +inf), not a hash map.
- Arc expansion gathers, per active slot, a fixed-width block of arc rows:
  either the arc-packed [E, 8] rows (il, ol, weight bits, dst and the
  destination's own table offsets, so the active set carries its offsets)
  or, for graphs that fit DENSE_ROWS_BUDGET, state-indexed [N, D, 4] rows.
  On the packed layout an arc budget M (`arc_budget_emit`,
  `arc_budget_x`) lays the active set's arcs out contiguously in M shared
  lanes instead (`_expand_compact`); arcs past the budget are dropped and
  counted in `overflow`.
- High-fanout "hub" states (graphs compiled with hub_threshold > 0) are
  expanded every frame from their own arc table; their lanes follow the
  gathered ones in the emit merge.
- Viterbi recombination + beam + top-K (`_dedup`) runs the CUDA kernel
  (ops/beam_cuda.py) on CUDA tensors whenever the padded proposal width
  fits its cap; wider merges, and every merge on the CPU, take the sort
  path `_dedup_and_prune`, as in the JAX package.
- Epsilon closure runs either as ONE precomputed transitive-closure
  expansion (graphs compiled with build_closure=True) or as eps-depth
  iterations over the eps table.
- Backpointers are composed within each frame: every frame emits one
  parent slot plus up to `max_olabels` output labels per slot, and
  `traceback` walks them on the host.

The frame step is a chain of tensor operations.  On the CPU the frame
loop is a Python loop over it.  On a CUDA device the loop runs in blocks
of F frames (`graph_block`): a block is one replay of a CUDA graph that
holds the F frames' whole chain, captured once per shape (`_FrameGraph`)
and kept by the decoder; the carry stays in the graph's buffers from
block to block.  A shape's first block runs eagerly (it warms the
allocator and readies kernel 2), and the last T' mod F frames, which no
block covers, run eagerly too; eager and replayed frames give the same
bits.  The spans `decode.*` of utils/profile.py time the search, each
frame (a replayed block: its time once, its frames as its count), the
eager frames' expansion, merge and closure, and the traceback.  The
same frame step serves the one-shot `make_beam_decoder` and, through
`make_beam_decoder(..., _internals=True)`, the chunked entry of
`StreamingBeamDecoder` and models/streaming.StreamingPipeline: the active
set is the carry between chunks, and `compose_chunk_paths` folds a
chunk's per-frame backpointers into one [B, K] summary on the device.
Blank-skip (`cfg.blank_skip`, decoder/frame_skip.py) is applied by the
callers (recipes/run.run_search, StreamingBeamDecoder.accept), not by the
search, as in the JAX package.  The light_* modes replace a merge's
recombination by a plain top-K (`_topk_prune`, torch ops, no kernel).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from eesen_tpu_torch.decoder.frame_skip import compact_blank_frames
from eesen_tpu_torch.decoder.graph_compile import CompiledGraph
from eesen_tpu_torch.models.model import as_tensor, check_device
from eesen_tpu_torch.ops import beam_cuda
from eesen_tpu_torch.parallel.distributed import all_gather
from eesen_tpu_torch.parallel.mesh import Mesh
from eesen_tpu_torch.parallel.sharding import local_rows
from eesen_tpu_torch.utils.profile import graph_counts, profiler

INF = float("inf")
MAX_OLABELS_PER_FRAME = 2   # words emitted by one frame's arc+eps chain

# The longest block of frames one CUDA graph replays, and the graphs one
# decoder keeps (each with its own memory pool; the least recently used
# is dropped first).
MAX_GRAPH_BLOCK = 64
MAX_GRAPHS = 4


@dataclasses.dataclass(frozen=True)
class BeamSearchConfig:
    beam: float = 16.0
    max_active: int = 4096          # K slots
    acoustic_scale: float = 0.9     # steps/decode_ctc_lat.sh default
    eps_iters: int = 0              # 0: use graph.eps_depth
    # BeamOutputs.lat_mask marks tokens within this of the frame best
    # (0: every finite token)
    lattice_beam: float = 0.0
    # words emitted by one frame's arc+eps chain; overflow beyond this is
    # counted in BeamOutputs.overflow (recipes re-decode with more)
    max_olabels: int = MAX_OLABELS_PER_FRAME
    # exact top-k by score narrows the K*D proposals to funnel_mult*K
    # before the recombination sort, on the sort path where no kernel
    # runs (the CPU); 0 disables
    funnel_mult: int = 0
    # keep the active set sorted by state id
    sort_active: bool = False
    # blank-frame skipping: frames whose blank posterior exceeds this are
    # merged into run-summed frames before the search
    # (decoder/frame_skip.py), by the callers; 0 disables
    blank_skip: float = 0.0
    # kept-frame counts are rounded up to this bucket
    blank_skip_bucket: int = 64
    # the JAX package's approximate top-k on its sort path; here the top-k
    # stays exact (`_smallest_k`), on the CPU and on the card
    approx_top_k: bool = False
    # plain top-K without recombination (`_topk_prune`) on every eps
    # iteration but the last (graphs without a closure) ...
    light_eps_dedup: bool = False
    # ... after the emitting phase ...
    light_emit_dedup: bool = False
    # ... or after the single closure expansion: duplicate states then
    # share the beam's slots, exact while max_active has headroom
    light_closure_dedup: bool = False
    # the JAX package's acoustic gather switch; `_acoustic_lookup` always
    # gathers, so it changes nothing here
    acoustic_gather: bool = False
    # the JAX package's frame-scan unroll factor; the frame loop here is a
    # Python loop, so it changes nothing
    scan_unroll: int = 1
    # compact (CSR) arc expansion budgets on the packed layout: M > 0 lays
    # the active set's arcs out in M shared lanes (clamped up to K);
    # arcs past the budget are dropped and counted in
    # BeamOutputs.overflow.  0 = one max-degree block per slot
    arc_budget_emit: int = 0
    arc_budget_x: int = 0


# Dense state-indexed arc rows replace the arc-packed layout whenever the
# padded [N, D, 4] tables fit this byte budget (as in the JAX package).
DENSE_ROWS_BUDGET = 64 * 1024 * 1024


def use_dense_rows(graph: CompiledGraph) -> bool:
    return graph.dense_bytes() <= DENSE_ROWS_BUDGET


class DeviceGraph(NamedTuple):
    """CompiledGraph arrays as device tensors.  Exactly one of the two
    layouts is populated (the other fields are zero-size): arc-packed
    ([E, 8] rows indexed base+j) or dense state-indexed rows ([N, D, 4]).
    The hub tables are zero-size on a graph without hubs."""
    emit_packed: torch.Tensor    # [Ee, 8] int32
    x_packed: torch.Tensor       # [Ex, 8] int32: closure if built, else eps
    emit_rows: torch.Tensor      # [N, De, 4] int32 (else [0, 1, 4])
    x_rows: torch.Tensor         # [N, Dx, 4] int32 (else [0, 1, 4])
    hub_src: torch.Tensor        # [H] int32 hub state ids
    hub_of_arc: torch.Tensor     # [Eh] int32 hub index of each hub arc
    hub_packed: torch.Tensor     # [Eh, 8] int32 hub arc rows
    final_weight: torch.Tensor   # [N] float32

    @classmethod
    def put(
        cls, g: CompiledGraph, dense: Optional[bool] = None, device="cuda",
    ) -> "DeviceGraph":
        device = check_device(device)
        if dense is None:
            dense = use_dense_rows(g)
        z = np.zeros((0, 1, 4), np.int32)
        if dense:
            emit_rows, x_rows = g.dense_rows()
            emit_packed = np.zeros((0, 8), np.int32)
            x_packed = np.zeros((0, 8), np.int32)
        else:
            emit_rows, x_rows = z, z
            emit_packed = g.emit_packed()
            x_packed = (
                g.closure_packed8() if g.has_closure else g.eps_packed()
            )
        if g.has_hubs:
            hub_src = g.hub_src
            hub_of_arc = np.repeat(
                np.arange(len(hub_src), dtype=np.int32),
                np.diff(g.hub_offsets),
            )
            hub_packed = g.hub_packed8()
        else:
            hub_src = hub_of_arc = np.zeros(0, np.int32)
            hub_packed = np.zeros((0, 8), np.int32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(t(emit_packed), t(x_packed), t(emit_rows), t(x_rows),
                   t(hub_src), t(hub_of_arc), t(hub_packed),
                   t(g.final_weight))


class BeamOutputs(NamedTuple):
    states: torch.Tensor       # [T, B, K] int32 active states (post closure)
    scores: torch.Tensor       # [T, B, K] float32
    parent: torch.Tensor       # [T, B, K] int32 slot in frame t-1
    olabels: torch.Tensor      # [T, B, K, max_olabels] int32 (0 = none)
    init_olabels: torch.Tensor  # [B, K, max_olabels] from the initial closure
    overflow: torch.Tensor     # [B] int32 count of dropped olabels
    lat_mask: torch.Tensor     # [T, B, K] bool

    def numpy(self) -> "BeamOutputs":
        """The same outputs as host numpy arrays (same shapes)."""
        return BeamOutputs(*(_np(x) for x in self))


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _bits_to_f32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.float32)


def _expand_dense(
    states: torch.Tensor, scores: torch.Tensor, rows_tbl: torch.Tensor,
):
    """Dense-layout expansion: one [D, 4] row gather by state id.
    Padding slots carry weight +inf and dead slots score +inf, so invalid
    proposals are +inf with no mask arithmetic.  -> [B, K*D] (dst, score,
    ilabel, olabel, dst offsets [B, K*D, 0])."""
    b, k = scores.shape
    n, d, _ = rows_tbl.shape
    m = k * d
    sid = states.clamp(0, max(n - 1, 0)).long()
    rows = rows_tbl[sid]                                  # [B, K, D, 4]
    score = scores[..., None] + _bits_to_f32(rows[..., 2])
    fin = torch.isfinite(score)
    zero = torch.zeros((), dtype=torch.int32, device=rows.device)
    il = torch.where(fin, rows[..., 0], zero)
    ol = torch.where(fin, rows[..., 1], zero)
    dst = torch.where(fin, rows[..., 3], zero)
    return (
        dst.reshape(b, m), score.reshape(b, m),
        il.reshape(b, m), ol.reshape(b, m),
        torch.zeros((b, m, 0), dtype=torch.int32, device=rows.device),
    )


def _expand(
    offs: torch.Tensor, scores: torch.Tensor, packed: torch.Tensor,
    degree_cap: int, which: int,
):
    """Arc-packed expansion: offs [B, K, 4] + scores [B, K] -> [B, K*D]
    (dst, score without acoustic, ilabel, olabel, dst offsets
    [B, K*D, 4]) by one block gather.  which: 0 = emit table offsets
    (fields 0, 1), 1 = closure/eps (fields 2, 3)."""
    b, k, _ = offs.shape
    m = k * degree_cap
    dev = offs.device
    base = offs[..., 2 * which]
    deg = offs[..., 2 * which + 1]
    j = torch.arange(degree_cap, dtype=torch.int32, device=dev)
    aid = base[..., None] + j                             # [B, K, D]
    valid = (j < deg[..., None]) & torch.isfinite(scores)[..., None]
    n_arcs = packed.shape[0]
    if n_arcs == 0:
        z = torch.zeros((b, m), dtype=torch.int32, device=dev)
        return (z, torch.full((b, m), INF, device=dev), z, z,
                torch.zeros((b, m, 4), dtype=torch.int32, device=dev))
    rows = packed[aid.clamp(0, n_arcs - 1).long()]        # [B, K, D, 8]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    il = torch.where(valid, rows[..., 0], zero)
    ol = torch.where(valid, rows[..., 1], zero)
    dst = torch.where(valid, rows[..., 3], zero)
    score = torch.where(
        valid, scores[..., None] + _bits_to_f32(rows[..., 2]), INF,
    )
    d_offs = torch.where(valid[..., None], rows[..., 4:8], zero)
    return (
        dst.reshape(b, m), score.reshape(b, m),
        il.reshape(b, m), ol.reshape(b, m), d_offs.reshape(b, m, 4),
    )


def _expand_compact(
    offs: torch.Tensor, scores: torch.Tensor, packed: torch.Tensor,
    which: int, m_budget: int,
):
    """CSR expansion: the active set's arcs laid out contiguously in
    `m_budget` shared lanes instead of one max-degree block per slot.
    offs [B, K, 4] + scores [B, K] -> (dst, score without acoustic,
    ilabel, olabel [B, M], dst offsets [B, M, 4], source slot [B, M]
    int64, arc overflow [B] int32).  Slot k owns lanes [cum[k], cum[k] +
    deg[k]), cum the exclusive cumsum of the live degrees; a lane's owner
    is the last slot with cum <= lane (zero-degree slots own no lane).
    Arcs past the budget are dropped and counted."""
    b, k, _ = offs.shape
    dev = offs.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    base = offs[..., 2 * which]
    deg = torch.where(torch.isfinite(scores), offs[..., 2 * which + 1],
                      zero).long()
    cum = torch.cumsum(deg, dim=1) - deg                  # exclusive
    total = cum[:, -1] + deg[:, -1]                       # [B]
    lane = torch.arange(m_budget, device=dev).repeat(b, 1)
    n_arcs = packed.shape[0]
    if n_arcs == 0:
        z = torch.zeros((b, m_budget), dtype=torch.int32, device=dev)
        return (z, torch.full((b, m_budget), INF, device=dev), z, z,
                torch.zeros((b, m_budget, 4), dtype=torch.int32, device=dev),
                z.long(), torch.zeros((b,), dtype=torch.int32, device=dev))
    src = (torch.searchsorted(cum, lane, right=True) - 1).clamp(0, k - 1)
    aid = base.gather(1, src) + (lane - cum.gather(1, src))
    valid = lane < total.clamp(max=m_budget)[:, None]
    rows = packed[aid.clamp(0, n_arcs - 1)]               # [B, M, 8]
    il = torch.where(valid, rows[..., 0], zero)
    ol = torch.where(valid, rows[..., 1], zero)
    dst = torch.where(valid, rows[..., 3], zero)
    score = torch.where(
        valid, scores.gather(1, src) + _bits_to_f32(rows[..., 2]), INF,
    )
    d_offs = torch.where(valid[..., None], rows[..., 4:8], zero)
    arc_overflow = (total - m_budget).clamp(min=0).int()
    return dst, score, il, ol, d_offs, src, arc_overflow


def _acoustic_lookup(
    ll_t: torch.Tensor, col: torch.Tensor, scale: float,
) -> torch.Tensor:
    """-scale * ll_t[b, col[b, m]] (the JAX package's one-hot contraction
    gives the same values: one nonzero term per sum)."""
    return (-scale) * ll_t.gather(1, col.long())


def _smallest_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest per row, ascending, lowest index first
    among ties (lax.top_k of -x)."""
    return torch.sort(x, dim=1, stable=True).indices[:, :k]


def _dedup_and_prune(
    dst: torch.Tensor, score: torch.Tensor, k: int, beam: float,
    funnel: int = 0,
):
    """Viterbi-recombine proposals sharing a destination state, apply the
    beam, keep the best K.  Returns (new_states [B, K] int32, new_scores
    [B, K], kept proposal idx [B, K] int64 into the proposal axis).

    One lexicographic (dst, score) sort makes the best proposal per state
    the first of its destination run.  With funnel > 0, an exact top-k by
    score first narrows the proposals to the `funnel` best; exact
    whenever the survivors cover >= k distinct destinations."""
    b, m = dst.shape
    dev = dst.device
    best = score.min(dim=1, keepdim=True).values
    score = torch.where(score <= best + beam, score, INF)
    idx0 = torch.arange(m, device=dev).expand(b, m)
    if 0 < funnel < m:
        fidx = _smallest_k(score, max(funnel, k))
        score = score.gather(1, fidx)
        dst = dst.gather(1, fidx)
        idx0 = fidx
    order = beam_cuda.lexsort_rows([dst, score])
    dst2 = dst.gather(1, order)
    score2 = score.gather(1, order)
    orig_idx = idx0.gather(1, order)
    first = torch.ones_like(dst2, dtype=torch.bool)
    first[:, 1:] = dst2[:, 1:] != dst2[:, :-1]
    score2 = torch.where(first, score2, INF)
    top_idx = _smallest_k(score2, k)
    new_scores = score2.gather(1, top_idx)
    new_states = torch.where(
        torch.isfinite(new_scores), dst2.gather(1, top_idx),
        torch.full_like(top_idx, -1, dtype=dst2.dtype),
    )
    kept = orig_idx.gather(1, top_idx)
    return new_states, new_scores, kept


def _topk_prune(dst: torch.Tensor, score: torch.Tensor, k: int):
    """Pruning without recombination (duplicate states may survive):
    the K best proposals, as (states [B, K], scores [B, K], idx [B, K])."""
    idx = _smallest_k(score, k)
    new_scores = score.gather(1, idx)
    new_states = torch.where(
        torch.isfinite(new_scores), dst.gather(1, idx),
        torch.full_like(idx, -1, dtype=dst.dtype),
    )
    return new_states, new_scores, idx


def _sort_by_state(states, scores, kept):
    """Reorder active slots ascending by state id (dead slots last)."""
    key = torch.where(
        states < 0, torch.full_like(states, 0x7FFFFFFF), states
    )
    order = torch.sort(key, dim=1, stable=True).indices
    return (states.gather(1, order), scores.gather(1, order),
            kept.gather(1, order))


def _append_olabel(olab: torch.Tensor, new: torch.Tensor,
                   overflow: torch.Tensor):
    """olab [B, M, L] existing labels, new [B, M] label (0 = none) ->
    appended; counts overflows (more than L labels in one frame)."""
    l = olab.shape[-1]
    count = (olab != 0).sum(dim=-1)                       # [B, M]
    can = count < l
    do = new != 0
    idx = count.clamp(0, l - 1)
    pos = torch.arange(l, device=olab.device)
    appended = torch.where(
        (pos == idx[..., None]) & (do & can)[..., None], new[..., None], olab,
    )
    overflow = overflow + (do & ~can).sum(dim=-1, dtype=torch.int32)
    return appended, overflow


def compose_chunk_paths(
    parent: torch.Tensor,    # [Tc, B, K] per-frame parent slots
    olabels: torch.Tensor,   # [Tc, B, K, L] per-frame output labels (0 = none)
    cap: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Collapse a chunk's per-frame backpointers into ONE summary, on
    their device: (entry [B, K], words [B, K, cap], wcount [B, K], wovf
    [B, K]), all int32.

    entry[b, k] = the slot at chunk start that slot k at chunk end
    descends from; words[b, k] = the olabels emitted along that path, in
    order (truncated at `cap`, overflow counted per slot).  Composing
    summaries chunk by chunk makes a streaming traceback walk chunks, not
    frames."""
    tc, b, k = parent.shape
    dev = parent.device
    entry = torch.arange(k, dtype=torch.int32, device=dev).repeat(b, 1)
    words = torch.zeros((b, k, cap), dtype=torch.int32, device=dev)
    cnt = torch.zeros((b, k), dtype=torch.int32, device=dev)
    ovf = torch.zeros((b, k), dtype=torch.int32, device=dev)
    pos = torch.arange(cap, dtype=torch.int32, device=dev)
    for t in range(tc):
        p_t = parent[t].long()
        entry = entry.gather(1, p_t)
        words = words.gather(1, p_t[..., None].expand(-1, -1, cap))
        cnt = cnt.gather(1, p_t)
        ovf = ovf.gather(1, p_t)
        for li in range(olabels.shape[-1]):
            new = olabels[t, ..., li]
            do = new != 0
            can = cnt < cap
            idx = cnt.clamp(0, cap - 1)
            words = torch.where(
                (pos == idx[..., None]) & (do & can)[..., None],
                new[..., None], words,
            )
            ovf = ovf + (do & ~can).int()
            cnt = cnt + (do & can).int()
    return entry, words, cnt, ovf


def graph_block(t: int) -> int:
    """Frames one CUDA graph replay searches in a search of t frames: the
    largest power of two from 2 to MAX_GRAPH_BLOCK that is at most t, or
    0 where none is (every frame then runs eagerly).  Blocks cover the
    first t - t % F frames; the rest run eagerly."""
    n = min(t, MAX_GRAPH_BLOCK)
    return 1 << (n.bit_length() - 1) if n >= 2 else 0


def _graphs_on(dev: torch.device) -> bool:
    """Whether the search on `dev` runs its frames in captured blocks."""
    return dev.type == "cuda"


def _on(dev: torch.device):
    """Make `dev` the current CUDA device inside the block (no-op off
    CUDA): a capture and a replay run on the current device's streams."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _capture(fn, dev: torch.device):
    """The CUDA work of fn() on `dev` as a graph (replay(), reset()); fn
    runs once, under capture, on a side stream of `dev`, with its memory
    in the graph's own pool."""
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(dev)
    assert stream.device == dev, (stream.device, dev)
    with torch.cuda.graph(g, stream=stream):
        fn()
    return g


def _no_span(name: str):
    return contextlib.nullcontext()


class _FrameGraph:
    """F frames of a decoder's search as one captured CUDA graph.

    Static buffers: the block's log-likelihoods [F, B, V] and `act` rows
    [F, B], the carry (read by the first frame, written by the last) and
    the F frames' stacked outputs [F, B, K(, L)].  Kernel 2's wrapper
    counts the launches a capture records under `beam_cuda.captured`;
    each replay adds them to `beam_cuda.launches`."""

    def __init__(self, frame, carry, ll: torch.Tensor, act: torch.Tensor,
                 dg: DeviceGraph):
        self.dev = ll.device
        self.ll = torch.zeros(ll.shape, dtype=ll.dtype, device=ll.device)
        self.act = torch.zeros(act.shape, dtype=act.dtype, device=act.device)
        self.carry = tuple(torch.zeros_like(x) for x in carry)
        captured = beam_cuda.captured

        def block():
            c, outs = self.carry, []
            for i in range(self.ll.shape[0]):
                c, out = frame(c, self.ll[i], self.act[i], dg, _no_span)
                outs.append(out)
            self.out = tuple(torch.stack(x) for x in zip(*outs))
            for dst, x in zip(self.carry, c):
                dst.copy_(x)

        with _on(self.dev):
            self.graph = _capture(block, self.dev)
        self.kernels = beam_cuda.captured - captured

    def run(self, carry, ll: torch.Tensor, act: torch.Tensor):
        """One replay over the block ll [F, B, V], act [F, B] from
        `carry` -> (the carry buffers, the stacked outputs)."""
        with _on(self.dev):
            if carry is not self.carry:
                for dst, x in zip(self.carry, carry):
                    dst.copy_(x)
            self.ll.copy_(ll)
            self.act.copy_(act)
            self.graph.replay()
        beam_cuda.launches += self.kernels
        return self.carry, self.out

    def release(self) -> None:
        """Free the graph and, with the last reference, its pool."""
        with _on(self.dev):
            self.graph.reset()
        self.out = None


def make_beam_decoder(
    graph: CompiledGraph, cfg: BeamSearchConfig = BeamSearchConfig(),
    _internals: bool = False,
):
    """Build a decoder: fn(loglikes [B, T, V], lengths [B], dg) ->
    BeamOutputs on the device of `dg`.  With `_internals`, return the
    chunked entry points instead, as the JAX package does:

    - init_chunk(b, dg) -> (carry, init_olabels [B, K, L]);
    - decode_chunk(carry, loglikes [B, Tc, V], active [B, Tc] bool, dg)
      -> (carry, (states, scores, parent, olabels, lat_mask)), each
      [Tc, B, K(, L)], the carry (states, scores, offsets, overflow) of
      the chunk's last frame."""
    k = cfg.max_active
    dense = use_dense_rows(graph)
    d_e = max(graph.max_emit_degree, 1)
    use_closure = graph.has_closure
    d_x = max(
        graph.max_closure_degree if use_closure else graph.max_eps_degree,
        1,
    )
    has_hubs = graph.has_hubs
    eps_iters = 1 if use_closure else (
        cfg.eps_iters or max(graph.eps_depth, 1)
    )
    beam = cfg.beam
    scale = cfg.acoustic_scale
    n_off = 0 if dense else 4
    start_offs = (
        None if dense else [int(x) for x in graph.state_offs(graph.start)]
    )
    funnel = cfg.funnel_mult * k if cfg.funnel_mult > 0 else 0
    # budgets apply to the packed layout and are clamped up to K: fewer
    # lanes than slots would leave the merge short of candidates
    m_e = 0 if dense or cfg.arc_budget_emit <= 0 else max(
        cfg.arc_budget_emit, k)
    m_x = 0 if dense or cfg.arc_budget_x <= 0 else max(cfg.arc_budget_x, k)
    L = max(cfg.max_olabels, 1)
    lat_beam = cfg.lattice_beam
    span = profiler.track

    def _dedup(dst: torch.Tensor, score: torch.Tensor):
        """Recombine + prune: the CUDA kernel when the padded width fits
        its cap, else the exact sort path (funnel only where no kernel
        runs, as the JAX package does)."""
        if dst.is_cuda and beam_cuda.padded_width(dst.shape[1]) \
                <= beam_cuda.MAX_LANES:
            st, sc, kept = beam_cuda.dedup_prune(dst, score, k, beam)
            out = (st, sc, kept.long())
        else:
            out = _dedup_and_prune(
                dst, score, k, beam, 0 if dst.is_cuda else funnel
            )
        return _sort_by_state(*out) if cfg.sort_active else out

    def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """x [B, M, C] rows picked by idx [B, K]."""
        return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))

    def _slot_of_lane(b: int, width: int, dev) -> torch.Tensor:
        """The source slot of each lane of a rectangular expansion of
        `width` lanes (width / K lanes a slot) -> [B, width] int64."""
        return (torch.arange(width, device=dev) // (width // k)).expand(
            b, width)

    def _x_step(carry, dg: DeviceGraph, full_dedup: bool):
        """One eps/closure expansion merged with the carried set;
        recombined by `_dedup`, or only pruned by `_topk_prune`."""
        states, scores, offs, parent, olab, overflow = carry
        if dense:
            dst, pscore, _, exp_ol, d_offs = _expand_dense(
                states, scores, dg.x_rows
            )
            src = None
        elif m_x > 0:
            dst, pscore, _, exp_ol, d_offs, src, arc_of = _expand_compact(
                offs, scores, dg.x_packed, 1, m_x
            )
            overflow = overflow + arc_of
        else:
            dst, pscore, _, exp_ol, d_offs = _expand(
                offs, scores, dg.x_packed, d_x, which=1
            )
            src = None
        exp_ol = torch.where(
            torch.isfinite(pscore), exp_ol, torch.zeros_like(exp_ol)
        )
        if src is None:
            src = _slot_of_lane(states.shape[0], pscore.shape[1],
                                pscore.device)
        exp_olab, overflow = _append_olabel(
            _take_rows(olab, src), exp_ol, overflow
        )
        all_dst = torch.cat([states.clamp(min=0), dst], dim=1)
        all_score = torch.cat([scores, pscore], dim=1)
        all_parent = torch.cat([parent, parent.gather(1, src)], dim=1)
        all_olab = torch.cat([olab, exp_olab], dim=1)
        all_offs = torch.cat([offs, d_offs], dim=1)
        if full_dedup:
            new_states, new_scores, top_idx = _dedup(all_dst, all_score)
        else:
            new_states, new_scores, top_idx = _topk_prune(
                all_dst, all_score, k
            )
        return (
            new_states, new_scores, _take_rows(all_offs, top_idx),
            all_parent.gather(1, top_idx), _take_rows(all_olab, top_idx),
            overflow,
        )

    def eps_phase(carry, dg: DeviceGraph):
        if use_closure:
            return _x_step(carry, dg, not cfg.light_closure_dedup)
        for i in range(eps_iters):
            # light_eps_dedup: recombine on the last iteration only
            carry = _x_step(carry, dg, not cfg.light_eps_dedup
                            or i == eps_iters - 1)
        return carry

    def init_active_set(b: int, dg: DeviceGraph):
        """Start-state active set after the initial eps closure."""
        dev = dg.final_weight.device
        states0 = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        states0[:, 0] = graph.start
        scores0 = torch.full((b, k), INF, device=dev)
        scores0[:, 0] = 0.0
        offs0 = torch.zeros((b, k, n_off), dtype=torch.int32, device=dev)
        if not dense:
            offs0[:, 0, :] = torch.tensor(
                start_offs, dtype=torch.int32, device=dev
            )
        parent0 = torch.arange(k, dtype=torch.int32, device=dev).repeat(b, 1)
        olab0 = torch.zeros((b, k, L), dtype=torch.int32, device=dev)
        overflow0 = torch.zeros((b,), dtype=torch.int32, device=dev)
        states0, scores0, offs0, _, init_olab, overflow0 = eps_phase(
            (states0, scores0, offs0, parent0, olab0, overflow0), dg
        )
        return (states0, scores0, offs0, overflow0), init_olab

    def hub_lanes(states, scores, ll_t, dg: DeviceGraph):
        """The emit lanes of the hub states, one per hub arc [B, Eh]:
        (dst, score with acoustic, olabel, parent slot, dst offsets).  A
        hub's source score is the best active slot on it (the first such
        slot is its parent)."""
        b, v = ll_t.shape
        eq = states[:, :, None] == dg.hub_src[None, None, :]
        msk = torch.where(
            eq & torch.isfinite(scores)[:, :, None], scores[:, :, None], INF,
        )                                                  # [B, K, H]
        hub_score = msk.amin(dim=1)                        # [B, H]
        hub_parent = msk.argmin(dim=1)                     # first minimum
        hp = dg.hub_packed
        arc_hub = dg.hub_of_arc.long()
        col = (hp[:, 0] - 1).clamp(0, v - 1).long()
        score = (hub_score[:, arc_hub] + _bits_to_f32(hp[:, 2])[None, :]
                 - scale * ll_t[:, col])
        eh = hp.shape[0]
        return (hp[None, :, 3].expand(b, eh), score,
                hp[None, :, 1].expand(b, eh), hub_parent[:, arc_hub],
                hp[None, :, 4:4 + n_off].expand(b, eh, n_off))

    def frame(carry, ll_t, act, dg: DeviceGraph, track=span):
        states, scores, offs, overflow = carry
        b, v = ll_t.shape
        with track("decode.expand"):
            parent_e = None
            if dense:
                dst, pscore, il, ol, d_offs = _expand_dense(
                    states, scores, dg.emit_rows
                )
            elif m_e > 0:
                (dst, pscore, il, ol, d_offs, parent_e,
                 arc_of) = _expand_compact(offs, scores, dg.emit_packed, 0,
                                           m_e)
                overflow = overflow + arc_of
            else:
                dst, pscore, il, ol, d_offs = _expand(
                    offs, scores, dg.emit_packed, d_e, which=0
                )
            col = (il - 1).clamp(0, v - 1)                     # tid-1 shift
            ac = _acoustic_lookup(ll_t, col, scale)
            pscore = torch.where(torch.isfinite(pscore), pscore + ac,
                                 torch.full_like(pscore, INF))
            if parent_e is None:
                parent_e = _slot_of_lane(b, pscore.shape[1], pscore.device)
            if has_hubs:
                # hub lanes after the gathered ones: lane order, and with it
                # the merge's tie order, is the JAX package's
                lanes = hub_lanes(states, scores, ll_t, dg)
                dst, pscore, ol, parent_e, d_offs = (
                    torch.cat([a, h], dim=1) for a, h in zip(
                        (dst, pscore, ol, parent_e, d_offs), lanes))
        with track("decode.merge"):
            if cfg.light_emit_dedup:
                e_states, e_scores, e_idx = _topk_prune(dst, pscore, k)
            else:
                e_states, e_scores, e_idx = _dedup(dst, pscore)
        parent = parent_e.gather(1, e_idx).int()
        e_offs = _take_rows(d_offs, e_idx)
        emit_ol = torch.where(
            torch.isfinite(e_scores), ol.gather(1, e_idx),
            torch.zeros_like(e_states),
        )
        olab, overflow = _append_olabel(
            torch.zeros((b, k, L), dtype=torch.int32, device=ll_t.device),
            emit_ol, overflow,
        )
        with track("decode.closure"):
            n_states, n_scores, n_offs, parent, olab, overflow = eps_phase(
                (e_states, e_scores, e_offs, parent, olab, overflow), dg
            )
        active = act[:, None]
        ident = torch.arange(k, dtype=torch.int32, device=ll_t.device)
        out = (
            torch.where(active, n_states, states),
            torch.where(active, n_scores, scores),
            torch.where(active, parent, ident),
            torch.where(active[..., None], olab, torch.zeros_like(olab)),
        )
        carry = (out[0], out[1],
                 torch.where(active[..., None], n_offs, offs), overflow)
        return carry, out

    def _check_layout(dg: DeviceGraph):
        have_dense = dg.emit_rows.shape[0] > 0
        if dense != have_dense:
            raise ValueError(
                f"decoder was built for the "
                f"{'dense-rows' if dense else 'arc-packed'} layout but the "
                f"DeviceGraph holds the other; build it with "
                f"DeviceGraph.put(graph) (auto) or put(graph, "
                f"dense={dense})"
            )

    # this decoder's captured blocks, least recently used first, and the
    # call in which each other block shape first ran eagerly
    graphs: "OrderedDict[tuple, _FrameGraph]" = OrderedDict()
    first_seen = {}
    calls = itertools.count()

    def block_graph(key, call: int, last: bool, carry, ll, act, dg):
        """The captured block for `key`, captured now where the shape has
        run eagerly before and the graph will be replayed again (in a
        later call, or by a later block of this one); else None (run the
        block eagerly)."""
        fg = graphs.get(key)
        if fg is not None:
            graphs.move_to_end(key)
            return fg
        seen = first_seen.get(key)
        if seen is None or (seen == call and last):
            first_seen.setdefault(key, call)
            return None
        if len(graphs) >= MAX_GRAPHS:
            graphs.popitem(last=False)[1].release()
        fg = graphs[key] = _FrameGraph(frame, carry, ll, act, dg)
        graph_counts["search_graph_captures"] += 1
        return fg

    def run_frames(carry, ll_tm: torch.Tensor, act: torch.Tensor,
                   dg: DeviceGraph):
        """The frame step over ll_tm [T, B, V] and act [T, B] bool ->
        (carry, (states, scores, parent, olabels, lat_mask)), stacked
        [T, B, K(, L)]."""
        t_max, b, v = ll_tm.shape
        dev = ll_tm.device
        states = torch.empty((t_max, b, k), dtype=torch.int32, device=dev)
        scores = torch.empty((t_max, b, k), dtype=torch.float32, device=dev)
        parent = torch.empty((t_max, b, k), dtype=torch.int32, device=dev)
        olabels = torch.empty((t_max, b, k, L), dtype=torch.int32, device=dev)
        outs = (states, scores, parent, olabels)

        def eager(carry, t0, t1):
            for t in range(t0, t1):
                with span("decode.frame"):
                    carry, out = frame(carry, ll_tm[t], act[t], dg)
                    states[t], scores[t], parent[t], olabels[t] = out
            return carry

        f = graph_block(t_max) if _graphs_on(dev) else 0
        n = t_max // f if f else 0
        key = (str(dev), b, f, v, tuple(
            (x.data_ptr(), tuple(x.shape)) for x in dg)) if f else None
        call = next(calls)
        fg = None
        for i in range(n):
            t0, t1 = i * f, (i + 1) * f
            fg = block_graph(key, call, i == n - 1, carry, ll_tm[t0:t1],
                             act[t0:t1], dg)
            if fg is None:
                carry = eager(carry, t0, t1)
                continue
            with span("decode.frame", f):
                carry, out = fg.run(carry, ll_tm[t0:t1], act[t0:t1])
                for dst, x in zip(outs, out):
                    dst[t0:t1].copy_(x)
            graph_counts["search_graph_frames"] += f
        carry = eager(carry, n * f, t_max)
        if fg is not None and carry is fg.carry:
            # hand back a carry of its own: the next replay rewrites these
            carry = tuple(x.clone() for x in carry)
        finite = torch.isfinite(scores)
        if lat_beam > 0.0:
            fbest = scores.min(dim=-1, keepdim=True).values
            lat_mask = finite & (scores <= fbest + lat_beam)
        else:
            lat_mask = finite
        return carry, (states, scores, parent, olabels, lat_mask)

    def decode(loglikes, lengths, dg: DeviceGraph) -> BeamOutputs:
        _check_layout(dg)
        with span("decode.search"):
            dev = dg.final_weight.device
            loglikes = as_tensor(loglikes, torch.float32).to(dev)
            lengths = as_tensor(lengths, torch.int64).to(dev)
            b, t_max, _ = loglikes.shape
            carry, init_olab = init_active_set(b, dg)
            act = torch.arange(t_max, device=dev)[:, None] < lengths[None, :]
            carry, (st, sc, par, ol, lm) = run_frames(
                carry, loglikes.transpose(0, 1), act, dg
            )
            return BeamOutputs(st, sc, par, ol, init_olab, carry[3], lm)

    def init_chunk(b: int, dg: DeviceGraph):
        _check_layout(dg)
        return init_active_set(b, dg)

    def decode_chunk(carry, loglikes, active, dg: DeviceGraph):
        _check_layout(dg)
        with span("decode.search"):
            dev = dg.final_weight.device
            loglikes = as_tensor(loglikes, torch.float32).to(dev)
            active = as_tensor(active, torch.bool).to(dev)
            return run_frames(
                carry, loglikes.transpose(0, 1), active.transpose(0, 1), dg
            )

    if _internals:
        return init_chunk, decode_chunk
    return decode


def make_sharded_beam_decoder(
    graph: CompiledGraph, cfg: BeamSearchConfig, mesh: Mesh,
    axis: str = "data",
):
    """Job-sharded decode over the mesh's `axis` ("data" or "model"), the
    graph on every rank (the reference's nj job shards,
    steps/decode_ctc_lat.sh:99-104).

    Returns fn(loglikes [B, T, V], lengths [B], dg) -> BeamOutputs of the
    whole batch, on every rank, as the JAX function's global arrays are.
    As the JAX function shards rows over `mesh[axis]` and replicates them
    over the other axis, each rank searches block i of B / size rows
    ((size, i): the axis's size and the rank's index on it) with
    make_beam_decoder, with no communication during the search; the
    outputs are then all-gathered over the axis's group on their batch
    axis (dim 1 of the [T, B, K(, L)] fields, dim 0 of init_olabels and
    overflow).  B must divide evenly."""
    mesh.axis(axis)                 # raises for an axis the mesh lacks
    base = make_beam_decoder(graph, cfg)

    def decode(loglikes, lengths, dg: DeviceGraph) -> BeamOutputs:
        loglikes = as_tensor(loglikes, torch.float32)
        lengths = as_tensor(lengths, torch.int64)
        lo, hi = local_rows(loglikes.shape[0], mesh, axis)
        out = base(loglikes[lo:hi], lengths[lo:hi], dg)

        def gather(x, dim):
            return all_gather(x, mesh, dim, axis)

        return BeamOutputs(
            gather(out.states, 1), gather(out.scores, 1),
            gather(out.parent, 1), gather(out.olabels, 1),
            gather(out.init_olabels, 0), gather(out.overflow, 0),
            # gloo gathers no bool
            gather(out.lat_mask.to(torch.uint8), 1).bool(),
        )

    return decode


def pack_summary(summary) -> torch.Tensor:
    """(entry, words, wcount, wovf) -> one [B, K, 3 + cap] int32 tensor,
    so that a chunk's summary reaches the host in one copy."""
    entry, words, cnt, ovf = summary
    return torch.cat(
        [entry[..., None], cnt[..., None], ovf[..., None], words], dim=-1
    )


def unpack_summary(packed: np.ndarray):
    """The host side of `pack_summary`: -> (entry, words, wcount, wovf)."""
    return packed[..., 0], packed[..., 3:], packed[..., 1], packed[..., 2]


class StreamingBeamDecoder:
    """Chunked (online) WFST decoding with carried search state
    (counterpart of the JAX package's StreamingBeamDecoder).

    The active set (states, scores, arc offsets, overflow) is an explicit
    carry, so audio is decoded chunk by chunk.  Each chunk's per-frame
    backpointers are composed on the device into one [B, K] summary
    (`compose_chunk_paths`) and copied to the host once per chunk, so
    finish() walks chunks, not frames, and partial() gives the current
    best hypothesis after any chunk.  Results equal a one-shot decode of
    the concatenated log-likelihoods.  The per-chunk word cap is sized
    from the chunk length when summary_words is None (`summarize`);
    overflow past an explicit cap raises OverflowError in finish() and
    truncates in partial(), which sets `state["truncated"]`.

        dec = StreamingBeamDecoder(graph, cfg)
        st = dec.start(batch_size)
        for chunk in chunks:             # [B, Tc, V] log-likes
            st = dec.accept(st, chunk)   # optional active mask [B, Tc]
            hyps = dec.partial(st)       # optional: current best words
        results = dec.finish(st)         # [(words, cost)] * B

    With cfg.blank_skip > 0 each chunk is blank-run merged before the
    search (decoder/frame_skip.py); `active` masks must then be
    contiguous prefixes per row (trailing padding).
    """

    def __init__(
        self, graph: CompiledGraph,
        cfg: BeamSearchConfig = BeamSearchConfig(),
        summary_words: Optional[int] = None,
        device="cuda",
    ):
        self._init, self._chunk = make_beam_decoder(
            graph, cfg, _internals=True
        )
        self.graph = graph
        self.cfg = cfg
        self.summary_words = summary_words
        self.dg = DeviceGraph.put(graph, device=device)

    def summarize(self, carry, loglikes, active):
        """One chunk of the search -> (carry, packed summary on the
        device, `pack_summary`)."""
        carry, (_, _, par, ol, _) = self._chunk(
            carry, loglikes, active, self.dg
        )
        cap = self.summary_words
        if cap is None:
            # one word per 2 frames (several-fold above real speech
            # rates), at least 16, at most the chunk's absolute emission
            # capacity tc * L, so short chunks can never overflow
            tc, n_ol = ol.shape[0], ol.shape[-1]
            cap = min(max(16, (tc + 1) // 2), tc * n_ol)
        return carry, pack_summary(compose_chunk_paths(par, ol, cap))

    def start(self, batch_size: int) -> dict:
        carry, init_olab = self._init(batch_size, self.dg)
        return {
            "carry": carry, "init_olab": _np(init_olab),
            "chunks": [],            # host (entry, words, cnt, ovf)
            "batch": batch_size, "tframes": 0,
        }

    def accept(self, state: dict, loglikes, active=None) -> dict:
        dev = self.dg.final_weight.device
        loglikes = as_tensor(loglikes, torch.float32).to(dev)
        b, t_c, _ = loglikes.shape
        if active is None:
            active = torch.ones((b, t_c), dtype=torch.bool, device=dev)
        else:
            active = as_tensor(active, torch.bool).to(dev)
        if self.cfg.blank_skip > 0.0:
            # per-chunk blank-run merging: a run that spans a chunk
            # boundary becomes one merged frame per chunk
            cf = compact_blank_frames(
                loglikes, active.sum(dim=1, dtype=torch.int32),
                self.cfg.blank_skip, bucket=self.cfg.blank_skip_bucket,
            )
            loglikes = cf.loglikes
            t_c = loglikes.shape[1]
            active = (torch.arange(t_c, device=dev)[None, :]
                      < cf.lengths[:, None])
        carry, summary = self.summarize(state["carry"], loglikes, active)
        state["carry"] = carry
        state["chunks"].append(unpack_summary(_np(summary)))  # one copy
        state["tframes"] += t_c
        return state

    def partial(self, state: dict) -> List[List[int]]:
        """Current best-path word hypotheses (ignores final weights: the
        utterances are still in progress)."""
        scores = _np(state["carry"][1])
        j = np.argmin(np.where(np.isfinite(scores), scores, np.inf), axis=1)
        return self._walk(state, j.astype(np.int64), strict=False)

    def _walk(
        self, state: dict, j: np.ndarray, strict: bool = True,
    ) -> List[List[int]]:
        b = state["batch"]
        slots = j.copy()
        rev: List[List[int]] = [[] for _ in range(b)]
        state["truncated"] = False
        for entry, words, cnt, ovf in reversed(state["chunks"]):
            for i in range(b):
                s = int(slots[i])
                if int(ovf[i, s]) > 0:
                    if strict:
                        raise OverflowError(
                            "chunk path emitted more than "
                            f"{words.shape[-1]} labels; re-run with a "
                            "larger summary_words (or summary_words="
                            "None to size it from the chunk length)"
                        )
                    # partial(): truncate and flag; an in-progress
                    # hypothesis may be dropped later anyway
                    state["truncated"] = True
                n = int(cnt[i, s])
                rev[i].extend(int(w) for w in words[i, s, :n][::-1])
                slots[i] = int(entry[i, s])
        out = []
        for i in range(b):
            lead = [int(w) for w in state["init_olab"][i, int(slots[i])]
                    if w != 0]
            out.append(lead + rev[i][::-1])
        return out

    def finish(self, state: dict) -> List[Tuple[List[int], float]]:
        states = _np(state["carry"][0])
        scores = _np(state["carry"][1])
        b = state["batch"]
        fw = self.graph.final_weight
        valid = states >= 0
        total = np.where(
            valid, scores + fw[np.maximum(states, 0)], np.inf
        )
        js = np.empty(b, np.int64)
        costs = np.empty(b, np.float64)
        for i in range(b):
            if np.isfinite(total[i]).any():
                js[i] = int(np.argmin(total[i]))
                costs[i] = float(total[i, js[i]])
            else:  # no final state: best partial path
                sc = np.where(valid[i], scores[i], np.inf)
                js[i] = int(np.argmin(sc))
                costs[i] = float(sc[js[i]])
        words = self._walk(state, js)
        return [(w, c) for w, c in zip(words, costs)]


def traceback(
    outputs: BeamOutputs,
    lengths: np.ndarray,
    final_weight: np.ndarray,
) -> List[Tuple[List[int], float]]:
    """Host-side best-path recovery.  Returns per utterance (word ids,
    total cost incl. final weight); falls back to the best non-final
    token when no final state survives (decoder-wrappers.cc 'partial
    traceback')."""
    with profiler.track("decode.traceback"):
        return _traceback(outputs, lengths, final_weight)


def _traceback(outputs, lengths, final_weight):
    st = _np(outputs.states)
    sc = _np(outputs.scores)
    par = _np(outputs.parent)
    ol = _np(outputs.olabels)
    init_ol = _np(outputs.init_olabels)
    lengths = _np(lengths)
    final_weight = _np(final_weight)
    t_max, b, k = st.shape
    results = []
    for i in range(b):
        t_last = int(lengths[i]) - 1
        if t_last < 0:
            results.append(([], 0.0))
            continue
        states_last = st[t_last, i]
        scores_last = sc[t_last, i].copy()
        valid = states_last >= 0
        fw = np.where(
            valid, final_weight[np.maximum(states_last, 0)], np.inf
        )
        total = scores_last + fw
        if np.isfinite(total).any():
            j = int(np.argmin(total))
            cost = float(total[j])
        else:  # no final state: best partial path
            scores_last[~valid] = np.inf
            j = int(np.argmin(scores_last))
            cost = float(scores_last[j])
        words_rev: List[int] = []
        for t in range(t_last, -1, -1):
            labs = ol[t, i, j]
            for w in labs[::-1]:
                if w != 0:
                    words_rev.append(int(w))
            j = int(par[t, i, j])
        for w in init_ol[i, j][::-1]:
            if w != 0:
                words_rev.append(int(w))
        results.append((words_rev[::-1], cost))
    return results
