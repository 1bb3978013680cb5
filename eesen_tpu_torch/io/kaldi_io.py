"""Kaldi-compatible table (archive) IO.

Binary-compatible reader/writer for the reference's ark/scp data plane
(reference: src/util/kaldi-table.h — Sequential/RandomAccess readers and
TableWriter; src/cpucompute/matrix.cc:967-1000 matrix serialization;
src/base/io-funcs-inl.h:91-123 integer vectors;
src/cpucompute/compressed-matrix.cc:404-470 the "CM" compressed format).

Formats handled:
  read : FM/DM float/double matrices, FV/DV vectors, CM compressed
         matrices (format 1), int32 vectors, text-mode entries
  write: FM float32 matrices, int32 vectors (binary), with optional scp

rspecifier support: "ark:file", "scp:file", "ark:-", gzip (by extension or
"ark:gunzip -c f.gz|"-style pipes), "file:offset" random access.  The
reference's full pipe-zoo (arbitrary shell commands) is supported through
`popen`-style pipes for read.
"""

from __future__ import annotations

import gzip
import io
import os
import struct
import subprocess
from typing import BinaryIO, Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np


# --------------------------------------------------------------------------
# low-level stream helpers
# --------------------------------------------------------------------------

def _read_key(f: BinaryIO) -> Optional[str]:
    """Read a whitespace-terminated utterance key; None at EOF."""
    chars = []
    while True:
        c = f.read(1)
        if not c:
            return None if not chars else "".join(chars)
        if c == b" ":
            if chars:
                return "".join(chars)
            continue
        if c in (b"\n", b"\t", b"\r"):
            if chars:
                return "".join(chars)
            continue
        chars.append(c.decode("utf-8"))


def _expect_token(f: BinaryIO) -> str:
    """Read a space-terminated token (after the binary header)."""
    tok = []
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok.append(c.decode("latin1"))
    return "".join(tok)


def _read_basic_int32(f: BinaryIO) -> int:
    sz = f.read(1)
    if sz != b"\x04":
        raise ValueError(f"expected int32 size marker, got {sz!r}")
    return struct.unpack("<i", f.read(4))[0]


def _write_basic_int32(f: BinaryIO, v: int) -> None:
    f.write(b"\x04")
    f.write(struct.pack("<i", v))


# --------------------------------------------------------------------------
# value readers
# --------------------------------------------------------------------------

def _read_compressed_matrix(f: BinaryIO) -> np.ndarray:
    """Decompress the reference's "CM" format-1 matrix
    (compressed-matrix.cc:436-470 read; CharToFloat :CharToFloat)."""
    min_value, value_range = struct.unpack("<ff", f.read(8))
    num_rows, num_cols = struct.unpack("<ii", f.read(8))
    if num_cols == 0:
        return np.zeros((0, 0), dtype=np.float32)
    col_headers = np.frombuffer(
        f.read(8 * num_cols), dtype=np.uint16
    ).reshape(num_cols, 4).astype(np.float32)
    # uint16 -> float percentiles
    p = min_value + col_headers * (value_range / 65535.0)  # [C, 4]
    data = np.frombuffer(
        f.read(num_rows * num_cols), dtype=np.uint8
    ).reshape(num_cols, num_rows).astype(np.float32)      # column-major
    p0, p25, p75, p100 = p[:, 0:1], p[:, 1:2], p[:, 2:3], p[:, 3:4]
    v = data
    lo = p0 + (p25 - p0) * v * (1 / 64.0)
    mid = p25 + (p75 - p25) * (v - 64.0) * (1 / 128.0)
    hi = p75 + (p100 - p75) * (v - 192.0) * (1 / 63.0)
    out = np.where(v <= 64, lo, np.where(v <= 192, mid, hi))
    return out.T.copy()  # [rows, cols]


def _read_compressed_matrix2(f: BinaryIO) -> np.ndarray:
    """Decompress the "CM2" format-2 matrix: all data is row-major
    uint16, value = min + range * v / 65535 (compressed-matrix.cc:85
    format choice for <=8 rows; Uint16ToFloat :233-239)."""
    min_value, value_range = struct.unpack("<ff", f.read(8))
    num_rows, num_cols = struct.unpack("<ii", f.read(8))
    if num_cols == 0 or num_rows == 0:
        return np.zeros((max(num_rows, 0), max(num_cols, 0)), np.float32)
    data = np.frombuffer(
        f.read(2 * num_rows * num_cols), dtype="<u2"
    ).reshape(num_rows, num_cols).astype(np.float32)
    return (min_value + data * (value_range / 65535.0)).astype(np.float32)


def _read_binary_value(f: BinaryIO) -> np.ndarray:
    tok = _expect_token(f)
    if tok in ("FM", "DM"):
        dtype = np.float32 if tok == "FM" else np.float64
        rows = _read_basic_int32(f)
        cols = _read_basic_int32(f)
        data = np.frombuffer(
            f.read(rows * cols * dtype().itemsize), dtype=dtype
        )
        return data.reshape(rows, cols).copy()
    if tok in ("FV", "DV"):
        dtype = np.float32 if tok == "FV" else np.float64
        n = _read_basic_int32(f)
        return np.frombuffer(f.read(n * dtype().itemsize), dtype=dtype).copy()
    if tok == "CM":
        return _read_compressed_matrix(f)
    if tok == "CM2":
        return _read_compressed_matrix2(f)
    raise ValueError(f"unknown binary token {tok!r}")


def _read_int_vector_binary(f: BinaryIO, first: bytes) -> np.ndarray:
    """Binary int32 vector, BOTH reference encodings:

    - table-holder format (util/kaldi-holder-inl.h:197-208
      BasicVectorHolder::Write — what Int32VectorWriter emits, e.g.
      latgen-faster's words/alignments arks): '\\x04'+count then
      PER-ELEMENT '\\x04'+int32 markers;
    - raw-array format (base/io-funcs-inl.h:91-103 WriteIntegerVector):
      '\\x04'+count then the packed int32 array.

    Disambiguated by validating the per-element markers; a raw vector
    whose every 5th byte happens to be 0x04 across all elements cannot
    also satisfy the trailing length check except for genuinely
    ambiguous content, which real label/word arks don't produce."""
    if first != b"\x04":
        raise ValueError("bad int-vector size marker")
    n = struct.unpack("<i", f.read(4))[0]
    if n == 0:
        return np.zeros((0,), np.int32)
    buf = f.read(4 * n)
    k = min(n, len(buf) // 5)
    markers = buf[:1] == b"\x04" and all(
        buf[5 * i] == 4 for i in range(k)
    )
    if markers:   # per-element format: 5 bytes/elem, read the remainder
        buf += f.read(5 * n - len(buf))
        a = np.frombuffer(buf, np.uint8).reshape(n, 5)
        if not (a[:, 0] == 4).all():
            raise ValueError("corrupt per-element int-vector markers")
        return a[:, 1:5].copy().view("<i4").reshape(n)
    return np.frombuffer(buf, dtype=np.int32).copy()


def _read_text_value(f: BinaryIO, first: bytes) -> np.ndarray:
    """Text-mode value: '[ ... ]' matrix/vector or bare int list to EOL."""
    line = first + f.readline()
    text = line.decode("utf-8").strip()
    if "[" not in text:
        # bare integer/float list (e.g. label archives written as text)
        vals = text.split()
        try:
            return np.array([int(v) for v in vals], dtype=np.int32)
        except ValueError:
            return np.array([float(v) for v in vals], dtype=np.float32)
    # matrix spanning multiple lines until ']'
    rows = []
    buf = text[text.index("[") + 1:]
    while "]" not in buf:
        if buf.strip():
            rows.append([float(v) for v in buf.split()])
        nxt = f.readline().decode("utf-8")
        if not nxt:
            raise ValueError("unterminated text matrix")
        buf = nxt
    last = buf[: buf.index("]")]
    if last.strip():
        rows.append([float(v) for v in last.split()])
    if rows and isinstance(rows[0], list) and len(rows) == 1:
        return np.asarray(rows[0], dtype=np.float32)
    return np.asarray(rows, dtype=np.float32)


def read_entry(f: BinaryIO) -> Optional[Tuple[str, np.ndarray]]:
    """Read one (key, value) from an ark stream; None at EOF."""
    key = _read_key(f)
    if key is None:
        return None
    first = f.read(1)
    if first == b"\x00":
        b = f.read(1)
        if b != b"B":
            raise ValueError("corrupt binary header")
        peek = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if peek == b"\x04":
            # could be int-vector or basic type; try int vector
            first2 = f.read(1)
            return key, _read_int_vector_binary(f, first2)
        return key, _read_binary_value(f)
    return key, _read_text_value(f, first)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def _open_maybe_pipe(path: str) -> BinaryIO:
    if path == "-":
        import sys
        return sys.stdin.buffer
    if path.endswith("|"):
        proc = subprocess.Popen(
            path[:-1], shell=True, stdout=subprocess.PIPE
        )
        return io.BufferedReader(proc.stdout)  # type: ignore[arg-type]
    offset = None
    if ":" in path and not os.path.exists(path):
        base, _, off = path.rpartition(":")
        if off.isdigit() and os.path.exists(base):
            path, offset = base, int(off)
    if path.endswith(".gz"):
        f: BinaryIO = gzip.open(path, "rb")  # type: ignore[assignment]
    else:
        f = open(path, "rb")
    if offset is not None:
        f.seek(offset)
    return io.BufferedReader(f) if not isinstance(f, io.BufferedReader) else f


def read_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Sequential reader over an archive file/pipe."""
    f = _open_maybe_pipe(path)
    try:
        while True:
            entry = read_entry(f)
            if entry is None:
                return
            yield entry
    finally:
        if f is not None and path != "-":
            f.close()


def read_scp(path: str) -> Dict[str, str]:
    """Parse an scp file into {key: extended-filename}."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, rest = line.partition(" ")
            out[key] = rest.strip()
    return out


def read_scp_entry(xfilename: str) -> np.ndarray:
    """Load one value from an 'path:offset' extended filename."""
    f = _open_maybe_pipe(xfilename)
    try:
        first = f.read(1)
        if first == b"\x00":
            b = f.read(1)
            if b != b"B":
                raise ValueError("corrupt binary header")
            peek = f.peek(1)[:1] if hasattr(f, "peek") else b""
            if peek == b"\x04":
                first2 = f.read(1)
                return _read_int_vector_binary(f, first2)
            return _read_binary_value(f)
        return _read_text_value(f, first)
    finally:
        f.close()


def read_rspecifier(rspec: str) -> Iterator[Tuple[str, np.ndarray]]:
    """'ark:...' sequential or 'scp:...' (iterated in file order)."""
    if rspec.startswith("ark:"):
        yield from read_ark(rspec[4:])
    elif rspec.startswith("scp:"):
        scp = read_scp(rspec[4:])
        for key, xfn in scp.items():
            yield key, read_scp_entry(xfn)
    else:
        yield from read_ark(rspec)


def write_compressed_matrix(f: BinaryIO, mat: np.ndarray) -> None:
    """Write the reference's compressed matrix: "CM" format 1 (>8 rows:
    per-column uint16 percentiles at 0/25/75/100 + uint8 piecewise-linear
    codes) or "CM2" format 2 (<=8 rows: all-uint16 row-major), matching
    compressed-matrix.cc:79-85's format choice."""
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    rows, cols = mat.shape
    min_v = float(mat.min()) if mat.size else 0.0
    rng_v = float(mat.max() - min_v) if mat.size else 0.0
    if rng_v == 0.0:
        rng_v = 1.0
    if rows <= 8:
        f.write(b"\x00BCM2 ")
        f.write(struct.pack("<ffii", min_v, rng_v, rows, cols))
        codes = np.clip(
            ((mat - min_v) / rng_v) * 65535 + 0.499, 0, 65535
        ).astype("<u2")
        f.write(codes.tobytes())
        return

    def f2u16(v):
        return np.clip(
            ((v - min_v) / rng_v) * 65535 + 0.499, 0, 65535
        ).astype(np.uint16)

    def u16tof(u):
        return min_v + u.astype(np.float64) * (rng_v / 65535.0)

    f.write(b"\x00BCM ")
    f.write(struct.pack("<ffii", min_v, rng_v, rows, cols))
    headers = np.zeros((cols, 4), dtype=np.uint16)
    codes = np.zeros((cols, rows), dtype=np.uint8)
    q = rows // 4
    for c in range(cols):
        col = np.sort(mat[:, c])
        p0 = min(int(f2u16(col[0])), 65532)
        p25 = min(max(int(f2u16(col[q])), p0 + 1), 65533)
        p75 = min(max(int(f2u16(col[3 * q])), p25 + 1), 65534)
        p100 = max(int(f2u16(col[-1])), p75 + 1)
        headers[c] = (p0, p25, p75, p100)
        fp = u16tof(np.asarray([p0, p25, p75, p100], np.uint16))
        v = mat[:, c].astype(np.float64)
        lo = 64.0 * (v - fp[0]) / max(fp[1] - fp[0], 1e-9)
        mid = 64 + 128.0 * (v - fp[1]) / max(fp[2] - fp[1], 1e-9)
        hi = 192 + 63.0 * (v - fp[2]) / max(fp[3] - fp[2], 1e-9)
        code = np.where(v <= fp[1], lo, np.where(v <= fp[2], mid, hi))
        codes[c] = np.clip(np.round(code), 0, 255).astype(np.uint8)
    f.write(headers.tobytes())
    f.write(codes.tobytes())


def write_matrix(f: BinaryIO, mat: np.ndarray) -> None:
    """Binary float32 matrix, byte-compatible with MatrixBase::Write."""
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    f.write(b"\x00BFM ")
    _write_basic_int32(f, mat.shape[0])
    _write_basic_int32(f, mat.shape[1])
    f.write(mat.tobytes())


def read_matrix(f: BinaryIO) -> np.ndarray:
    first = f.read(2)
    if first != b"\x00B":
        raise ValueError("expected binary header")
    return _read_binary_value(f)


def _write_int_vector(f: BinaryIO, vec: np.ndarray) -> None:
    # table-holder layout (BasicVectorHolder::Write,
    # util/kaldi-holder-inl.h:197-208): per-element '\x04' markers —
    # the format the reference's Int32Vector table READERS expect
    vec = np.ascontiguousarray(vec, dtype=np.int32)
    f.write(b"\x00B\x04")
    f.write(struct.pack("<i", len(vec)))
    out = np.empty((len(vec), 5), np.uint8)
    out[:, 0] = 4
    out[:, 1:5] = vec.view(np.uint8).reshape(len(vec), 4)
    f.write(out.tobytes())


def write_ark(
    path: str,
    items: Iterable[Tuple[str, np.ndarray]],
    scp_path: Optional[str] = None,
    compress: bool = False,
) -> None:
    """Write a binary archive (+ optional scp with offsets).
    compress=True stores float matrices in the lossy "CM" format
    (the reference's --compress=true)."""
    scp_f = open(scp_path, "w") if scp_path else None
    with open(path, "wb") as f:
        for key, value in items:
            f.write(key.encode("utf-8") + b" ")
            offset = f.tell()
            value = np.asarray(value)
            if np.issubdtype(value.dtype, np.integer):
                _write_int_vector(f, value)
            elif value.ndim == 2 and compress:
                write_compressed_matrix(f, value)
            elif value.ndim == 2:
                write_matrix(f, value)
            else:
                value = np.ascontiguousarray(value, dtype=np.float32)
                f.write(b"\x00BFV ")
                _write_basic_int32(f, len(value))
                f.write(value.tobytes())
            if scp_f:
                scp_f.write(f"{key} {os.path.abspath(path)}:{offset}\n")
    if scp_f:
        scp_f.close()
