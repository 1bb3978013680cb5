"""Lattice archive IO, Kaldi-compatible.

Reads and writes lattices in the reference's text CompactLattice-style
format and in the plain Lattice text format
(reference: src/lat/kaldi-lattice.{h,cc} — LatticeHolder/
CompactLatticeHolder; lattice text lines are
`src dst ilabel olabel graph_cost,acoustic_cost[,string]` with final
lines `state cost[,cost]`), so lattices decoded here can be post-processed
by Kaldi/eesen tools and vice versa.

Archive framing matches kaldi_io: `key ` then the text lattice terminated
by an empty line (the reference's text-mode tables).
"""

from __future__ import annotations

from typing import BinaryIO, Dict, Iterator, List, Optional, TextIO, Tuple

from eesen_tpu_torch.decoder.lattice import Lattice, LatticeArc

INF = float("inf")


def write_lattice_text(lat: Lattice, f: TextIO) -> None:
    """Plain Lattice text format: weights are (graph_cost, acoustic_cost)."""
    n = lat.num_states
    order = sorted(range(n), key=lambda s: (lat.state_frame[s], s))
    remap = {s: i for i, s in enumerate(order)}
    # ensure the start state prints first (Kaldi convention: state 0)
    if lat.start in remap and remap[lat.start] != 0:
        other = order[0]
        order[0], order[remap[lat.start]] = lat.start, other
        remap = {s: i for i, s in enumerate(order)}
    for s in order:
        for a in lat.arcs[s]:
            f.write(
                f"{remap[s]}\t{remap[a.nextstate]}\t{a.ilabel}\t{a.olabel}\t"
                f"{a.graph_cost:.7g},{a.acoustic_cost:.7g}\n"
            )
        if s in lat.finals:
            f.write(f"{remap[s]}\t{lat.finals[s]:.7g},0\n")


def read_lattice_text(lines: List[str]) -> Lattice:
    lat = Lattice()
    ids: Dict[int, int] = {}

    def state(x: int) -> int:
        if x not in ids:
            ids[x] = lat.add_state(-1)
        return ids[x]

    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if len(parts) >= 4:
            s, d = state(int(parts[0])), state(int(parts[1]))
            il, ol = int(parts[2]), int(parts[3])
            gc = ac = 0.0
            if len(parts) >= 5:
                w = parts[4].split(",")
                gc = float(w[0]) if w[0] else 0.0
                ac = float(w[1]) if len(w) > 1 and w[1] else 0.0
            lat.arcs[s].append(LatticeArc(il, ol, gc, ac, d))
        elif len(parts) <= 2:
            s = state(int(parts[0]))
            w = parts[1].split(",") if len(parts) == 2 else ["0"]
            lat.finals[s] = float(w[0]) if w[0] else 0.0
    if ids:
        lat.start = ids[min(ids)]
    # recover frame order topologically (frames unknown from text: use BFS
    # depth as a stand-in so best_path's topological order works)
    _assign_frames(lat)
    return lat


def _assign_frames(lat: Lattice) -> None:
    n = lat.num_states
    depth = [0] * n
    # longest-path depth via repeated relaxation (lattices are small DAGs)
    for _ in range(n):
        changed = False
        for s in range(n):
            for a in lat.arcs[s]:
                if depth[s] + 1 > depth[a.nextstate]:
                    depth[a.nextstate] = depth[s] + 1
                    changed = True
        if not changed:
            break
    lat.state_frame = depth


def determinize_lattice(
    lat: Lattice,
    acoustic_scale: float = 1.0,
    lattice_beam: float = 10.0,
) -> Lattice:
    """Word-level lattice determinization in the PAIR semiring.

    Delegates to clat.determinize_lattice_pruned — the analogue of the
    reference's DeterminizeLatticePruned wrapper after decoding
    (src/lat/determinize-lattice-pruned.{h,cc} via
    decoder-wrappers.cc:87-99): merge all paths with the same word
    sequence keeping the best, producing a compact word DAG.  Graph and
    acoustic costs stay SEPARATE through determinization, so the result
    rescales correctly at any later acoustic scale; acoustic_scale is
    kept only in the signature for compatibility and no longer flattens
    the pair (pass it to .scale()/.scaled() afterwards instead)."""
    from eesen_tpu_torch.decoder.clat import (
        compact_to_lattice, determinize_lattice_pruned,
    )
    clat = determinize_lattice_pruned(lat, lattice_beam=lattice_beam)
    return compact_to_lattice(clat)


# ---------------------------------------------------------------------
# CompactLattice text format
# ---------------------------------------------------------------------

def write_compact_lattice_text(clat: "CompactLattice", f: TextIO) -> None:
    """Acceptor text format: `src dst word g,a,i1_i2` with final lines
    `state g,a,string` (reference: fst::FstPrinter acceptor output +
    CompactLatticeWeight operator<< — lattice-weight.h:676-687; weight
    separator ',', string separator '_')."""
    order = list(range(clat.num_states))
    if clat.start != 0:
        order[0], order[clat.start] = clat.start, 0
    remap = {s: i for i, s in enumerate(order)}
    for s in order:
        for a in clat.arcs[s]:
            ils = "_".join(str(i) for i in a.ilabels)
            f.write(
                f"{remap[s]}\t{remap[a.nextstate]}\t{a.word}\t"
                f"{a.graph_cost:.7g},{a.acoustic_cost:.7g},{ils}\n"
            )
        if s in clat.finals:
            g, ac, fil = clat.finals[s]
            ils = "_".join(str(i) for i in fil)
            f.write(f"{remap[s]}\t{g:.7g},{ac:.7g},{ils}\n")


def read_compact_lattice_text(lines: List[str]) -> "CompactLattice":
    from eesen_tpu_torch.decoder.clat import CompactArc, CompactLattice

    clat = CompactLattice()
    ids: Dict[int, int] = {}

    def state(x: int) -> int:
        if x not in ids:
            ids[x] = clat.add_state()
        return ids[x]

    def weight(tok: str) -> Tuple[float, float, Tuple[int, ...]]:
        parts = tok.split(",")
        g = float(parts[0]) if parts and parts[0] else 0.0
        ac = float(parts[1]) if len(parts) > 1 and parts[1] else 0.0
        ils: Tuple[int, ...] = ()
        if len(parts) > 2 and parts[2]:
            ils = tuple(int(x) for x in parts[2].split("_"))
        return g, ac, ils

    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if len(parts) >= 3:
            s, d = state(int(parts[0])), state(int(parts[1]))
            word = int(parts[2])
            g, ac, ils = weight(parts[3]) if len(parts) > 3 else (0.0, 0.0, ())
            clat.arcs[s].append(CompactArc(word, g, ac, ils, d))
        else:
            s = state(int(parts[0]))
            clat.finals[s] = (
                weight(parts[1]) if len(parts) > 1 else (0.0, 0.0, ())
            )
    if ids:
        clat.start = ids[min(ids)]
    return clat


# ---------------------------------------------------------------------
# Binary format (OpenFst VectorFst layout, little-endian)
# ---------------------------------------------------------------------
#
# The reference writes binary lattices as OpenFst VectorFsts with the
# CompactLatticeWeight/LatticeWeight arc types (src/lat/kaldi-lattice.cc:62
# WriteCompactLattice -> t.Write(os, opts); holders detect binary by the
# FST magic's first byte 214 — kaldi-lattice.cc:372-390).  Layout:
#   int32 magic (2125659606), string fsttype ("vector"), string arctype,
#   int32 version (2), int32 flags, uint64 properties, int64 start,
#   int64 numstates, int64 numarcs; then per state: final weight,
#   int64 narcs, arcs (int32 ilabel, int32 olabel, weight, int32 nextstate).
# Weights: lattice4 = 2 float32; compactlattice44 adds int32 count +
# int32 labels (fstext/lattice-weight.h:129-147,483-498).

_FST_MAGIC = 2125659606
_F32_INF = float("inf")


def _w_int32(f: BinaryIO, v: int) -> None:
    f.write(int(v).to_bytes(4, "little", signed=True))


def _w_int64(f: BinaryIO, v: int) -> None:
    f.write(int(v).to_bytes(8, "little", signed=True))


def _w_f32(f: BinaryIO, v: float) -> None:
    import struct
    f.write(struct.pack("<f", v))


def _w_str(f: BinaryIO, s: str) -> None:
    b = s.encode()
    _w_int32(f, len(b))
    f.write(b)


class _BinReader:
    def __init__(self, f: BinaryIO) -> None:
        self.f = f

    def i32(self) -> int:
        return int.from_bytes(self.f.read(4), "little", signed=True)

    def i64(self) -> int:
        return int.from_bytes(self.f.read(8), "little", signed=True)

    def u64(self) -> int:
        return int.from_bytes(self.f.read(8), "little", signed=False)

    def f32(self) -> float:
        import struct
        return struct.unpack("<f", self.f.read(4))[0]

    def f64(self) -> float:
        import struct
        return struct.unpack("<d", self.f.read(8))[0]

    def s(self) -> str:
        n = self.i32()
        return self.f.read(n).decode()


def _write_fst_header(
    f: BinaryIO, arctype: str, start: int, nstates: int, narcs: int
) -> None:
    _w_int32(f, _FST_MAGIC)
    _w_str(f, "vector")
    _w_str(f, arctype)
    _w_int32(f, 2)            # VectorFst file version
    _w_int32(f, 0)            # flags: no symbol tables
    f.write((0x3).to_bytes(8, "little"))   # properties: expanded|mutable
    _w_int64(f, start)
    _w_int64(f, nstates)
    _w_int64(f, narcs)


def write_lattice_binary(lat: Lattice, f: BinaryIO) -> None:
    """Binary Lattice (arc type lattice4)."""
    n = lat.num_states
    order = sorted(range(n), key=lambda s: (lat.state_frame[s], s))
    if lat.start in order and order.index(lat.start) != 0:
        i = order.index(lat.start)
        order[0], order[i] = order[i], order[0]
    remap = {s: i for i, s in enumerate(order)}
    _write_fst_header(f, "lattice4", 0 if n else -1, n, lat.num_arcs)
    for s in order:
        if s in lat.finals:
            _w_f32(f, lat.finals[s])
            _w_f32(f, 0.0)
        else:
            _w_f32(f, _F32_INF)
            _w_f32(f, _F32_INF)
        _w_int64(f, len(lat.arcs[s]))
        for a in lat.arcs[s]:
            _w_int32(f, a.ilabel)
            _w_int32(f, a.olabel)
            _w_f32(f, a.graph_cost)
            _w_f32(f, a.acoustic_cost)
            _w_int32(f, remap[a.nextstate])


def write_compact_lattice_binary(clat: "CompactLattice", f: BinaryIO) -> None:
    """Binary CompactLattice (arc type compactlattice44)."""
    n = clat.num_states
    order = list(range(n))
    if clat.start != 0 and n:
        order[0], order[clat.start] = clat.start, 0
    remap = {s: i for i, s in enumerate(order)}
    _write_fst_header(
        f, "compactlattice44", 0 if n else -1, n, clat.num_arcs
    )
    for s in order:
        if s in clat.finals:
            g, ac, fil = clat.finals[s]
            _w_f32(f, g)
            _w_f32(f, ac)
            _w_int32(f, len(fil))
            for i in fil:
                _w_int32(f, i)
        else:
            _w_f32(f, _F32_INF)
            _w_f32(f, _F32_INF)
            _w_int32(f, 0)
        _w_int64(f, len(clat.arcs[s]))
        for a in clat.arcs[s]:
            _w_int32(f, a.word)
            _w_int32(f, a.word)   # acceptor: ilabel == olabel == word
            _w_f32(f, a.graph_cost)
            _w_f32(f, a.acoustic_cost)
            _w_int32(f, len(a.ilabels))
            for i in a.ilabels:
                _w_int32(f, i)
            _w_int32(f, remap[a.nextstate])


def write_fst_binary(fst, f: BinaryIO) -> None:
    """Write a tropical-weight Fst (decoder/fst.Fst) as an OpenFst
    binary VectorFst<StdArc> (arctype "standard", 1-float weights) —
    the file format the reference's `fst::ReadFstKaldi` loads as a
    decode graph (fstext/fstext-utils-inl.h:1267), used to hand our TLG
    to the compiled reference latgen-faster for cross-validation."""
    n = fst.num_states
    # OpenFst has no separate final set: weight inf == not final
    order = list(range(n))
    if n and fst.start > 0:
        order[0], order[fst.start] = fst.start, 0
    remap = {s: i for i, s in enumerate(order)}
    _write_fst_header(f, "standard", 0 if n else -1, n, fst.num_arcs)
    for s in order:
        _w_f32(f, fst.finals.get(s, _F32_INF))
        _w_int64(f, len(fst.arcs[s]))
        for a in fst.arcs[s]:
            _w_int32(f, a.ilabel)
            _w_int32(f, a.olabel)
            _w_f32(f, a.weight)
            _w_int32(f, remap[a.nextstate])


def write_compiled_graph_binary(cg, f: BinaryIO) -> None:
    """Write a CompiledGraph's base arc tables (emit + eps CSR) as an
    OpenFst binary VectorFst<StdArc> — vectorized (no per-arc Python),
    so the LM-scale 3M-state graphs serialize in seconds.

    This emits the EXACT automaton the TPU beam search walks (after
    degree capping), which is what the reference latgen-faster should
    search for a decoder-level parity test (hub/closure tables are
    derived acceleration structures, not part of the automaton)."""
    import numpy as np

    n = int(cg.num_states)
    e_cnt = np.diff(cg.emit_offsets).astype(np.int64)
    x_cnt = np.diff(cg.eps_offsets).astype(np.int64)
    narcs = e_cnt + x_cnt
    total_arcs = int(narcs.sum())

    # combined per-state arc stream: eps arcs first, then emitting
    il = np.empty(total_arcs, np.int32)
    ol = np.empty(total_arcs, np.int32)
    wt = np.empty(total_arcs, np.float32)
    dst = np.empty(total_arcs, np.int32)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(narcs, out=starts[1:])
    # scatter eps arcs: position starts[s] + rank
    src_e = np.repeat(np.arange(n), x_cnt)
    rank_e = np.arange(len(src_e)) - np.repeat(
        cg.eps_offsets[:-1].astype(np.int64), x_cnt)
    pos = starts[src_e] + rank_e
    il[pos] = 0
    ol[pos] = cg.eps_olabel
    wt[pos] = cg.eps_weight
    dst[pos] = cg.eps_dst
    # emitting arcs after the eps block
    src_m = np.repeat(np.arange(n), e_cnt)
    rank_m = np.arange(len(src_m)) - np.repeat(
        cg.emit_offsets[:-1].astype(np.int64), e_cnt)
    pos = starts[src_m] + x_cnt[src_m] + rank_m
    il[pos] = cg.emit_ilabel
    ol[pos] = cg.emit_olabel
    wt[pos] = cg.emit_weight
    dst[pos] = cg.emit_dst

    # state 0 must be the start state in the file (header start idx is
    # free in OpenFst, so just record cg.start — no remap needed)
    _write_fst_header(f, "standard", int(cg.start), n, total_arcs)

    # serialize with vectorized scatter into one byte buffer:
    # per state: f32 final + i64 narcs (12 B); per arc: 16 B
    hdr_bytes = 12 * n
    out = np.empty(hdr_bytes + 16 * total_arcs, np.uint8)
    block_start = np.zeros(n, np.int64)
    np.cumsum(12 + 16 * narcs[:-1], out=block_start[1:])
    # finals (inf = non-final already in final_weight)
    fin = np.asarray(cg.final_weight, np.float32).view(np.uint8)
    idx = block_start[:, None] + np.arange(4)
    out[idx] = fin.reshape(n, 4)
    nb = narcs.astype("<i8").view(np.uint8).reshape(n, 8)
    idx = block_start[:, None] + 4 + np.arange(8)
    out[idx] = nb
    # arcs
    rec = np.empty((total_arcs, 16), np.uint8)
    rec[:, 0:4] = il.astype("<i4").view(np.uint8).reshape(-1, 4)
    rec[:, 4:8] = ol.astype("<i4").view(np.uint8).reshape(-1, 4)
    rec[:, 8:12] = wt.astype("<f4").view(np.uint8).reshape(-1, 4)
    rec[:, 12:16] = dst.astype("<i4").view(np.uint8).reshape(-1, 4)
    arc_pos = (block_start + 12)[np.repeat(np.arange(n), narcs)] \
        + 16 * (np.arange(total_arcs)
                - np.repeat(starts[:-1], narcs))
    idx = arc_pos[:, None] + np.arange(16)
    out[idx] = rec
    f.write(out.tobytes())


def read_fst_binary(f: BinaryIO):
    """Read an OpenFst binary VectorFst<StdArc> into decoder/fst.Fst."""
    from eesen_tpu_torch.decoder.fst import Arc, Fst

    r = _BinReader(f)
    magic = r.i32()
    if magic != _FST_MAGIC:
        raise ValueError(f"bad FST magic {magic}")
    fsttype, arctype = r.s(), r.s()
    if fsttype != "vector" or arctype != "standard":
        raise ValueError(f"unsupported fst {fsttype}/{arctype}")
    r.i32()          # version
    r.i32()          # flags
    r.u64()          # properties
    start = r.i64()
    nstates = r.i64()
    r.i64()          # narcs
    out = Fst()
    for _ in range(nstates):
        out.add_state()
    for s in range(nstates):
        w = r.f32()
        if w != _F32_INF:
            out.set_final(s, w)
        narcs = r.i64()
        for _ in range(narcs):
            il, ol = r.i32(), r.i32()
            aw = r.f32()
            ns = r.i32()
            out.add_arc(s, Arc(il, ol, aw, ns))
    if nstates:
        out.set_start(int(start))
    return out


def read_lattice_binary(f: BinaryIO):
    """Read a binary Lattice or CompactLattice; returns whichever type
    the arc type declares (lattice4/8 -> Lattice, compactlattice44/84 ->
    CompactLattice), like the reference's type-dispatching
    ReadCompactLattice (kaldi-lattice.cc:310-355)."""
    from eesen_tpu_torch.decoder.clat import CompactArc, CompactLattice

    r = _BinReader(f)
    magic = r.i32()
    if magic != _FST_MAGIC:
        raise ValueError(f"bad FST magic {magic}")
    fsttype = r.s()
    if fsttype != "vector":
        raise ValueError(f"unsupported FST type {fsttype!r}")
    arctype = r.s()
    version = r.i32()
    if version < 1:
        raise ValueError(f"bad VectorFst version {version}")
    r.i32()                   # flags
    r.u64()                   # properties
    start = r.i64()
    nstates = r.i64()
    r.i64()                   # numarcs
    if arctype in ("lattice4", "lattice8"):
        dbl = arctype.endswith("8")
        rf = r.f64 if dbl else r.f32
        lat = Lattice()
        for _ in range(nstates):
            lat.add_state(-1)
        lat.start = max(start, 0)
        for s in range(nstates):
            g, ac = rf(), rf()
            if g != _F32_INF and ac != _F32_INF:
                lat.finals[s] = g + ac
            narcs = r.i64()
            for _ in range(narcs):
                il, ol = r.i32(), r.i32()
                ag, aac = rf(), rf()
                d = r.i32()
                lat.arcs[s].append(LatticeArc(il, ol, ag, aac, d))
        _assign_frames(lat)
        return lat
    if arctype in ("compactlattice44", "compactlattice84"):
        dbl = "8" in arctype[len("compactlattice"):][:1]
        rf = r.f64 if dbl else r.f32
        clat = CompactLattice()
        for _ in range(nstates):
            clat.add_state()
        clat.start = max(start, 0)
        for s in range(nstates):
            g, ac = rf(), rf()
            cnt = r.i32()
            fil = tuple(r.i32() for _ in range(cnt))
            if g != _F32_INF and ac != _F32_INF:
                clat.finals[s] = (g, ac, fil)
            narcs = r.i64()
            for _ in range(narcs):
                word = r.i32()
                r.i32()       # olabel == word (acceptor)
                ag, aac = rf(), rf()
                cnt = r.i32()
                ils = tuple(r.i32() for _ in range(cnt))
                d = r.i32()
                clat.arcs[s].append(CompactArc(word, ag, aac, ils, d))
        return clat
    raise ValueError(f"unsupported lattice arc type {arctype!r}")


def write_lattice_ark(
    path: str, items: Iterator[Tuple[str, "object"]], binary: bool = False
) -> None:
    """Lattice/CompactLattice archive.  Text framing: `key \\n` + FST text
    + blank line; binary framing: `key ` + OpenFst binary (the holders
    write no extra \\0B header — kaldi-lattice.h LatticeHolder::Write)."""
    from eesen_tpu_torch.decoder.clat import CompactLattice

    if binary:
        with open(path, "wb") as f:
            for key, lat in items:
                f.write(key.encode() + b" ")
                if isinstance(lat, CompactLattice):
                    write_compact_lattice_binary(lat, f)
                else:
                    write_lattice_binary(lat, f)
        return
    with open(path, "w") as f:
        for key, lat in items:
            f.write(f"{key} \n")
            if isinstance(lat, CompactLattice):
                write_compact_lattice_text(lat, f)
            else:
                write_lattice_text(lat, f)
            f.write("\n")


def read_lattice_ark(path: str) -> Iterator[Tuple[str, "object"]]:
    """Auto-detecting archive reader: per entry, after `key `, a byte 214
    (the FST magic's first byte) means OpenFst binary, whitespace means a
    text lattice (the reference's detection — kaldi-lattice.cc:372-390).
    Yields Lattice or CompactLattice according to the stored arc type;
    text entries with 3-part weights parse as CompactLattice."""
    with open(path, "rb") as f:
        while True:
            # read key
            key_b = bytearray()
            c = f.read(1)
            if not c:
                return
            while c not in (b" ", b""):
                key_b += c
                c = f.read(1)
            if not key_b:
                continue
            key = key_b.decode()
            pos = f.tell()
            probe = f.read(1)
            if probe == b"\xd6":
                f.seek(pos)
                yield key, read_lattice_binary(f)
                continue
            # text entry: consume up to newline, then lines until blank
            while probe not in (b"\n", b""):
                probe = f.read(1)
            lines: List[str] = []
            compact = False
            while True:
                raw = f.readline()
                if not raw or not raw.strip():
                    break
                line = raw.decode().rstrip("\n")
                parts = line.split()
                w = parts[-1] if parts else ""
                if (
                    len(parts) in (2, 4)
                    and w.count(",") == 2
                ):
                    compact = True
                lines.append(line)
            if compact:
                yield key, read_compact_lattice_text(lines)
            else:
                yield key, read_lattice_text(lines)
