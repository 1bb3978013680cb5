"""ctypes bridge to the native WFST library (fstlib.cpp, beside this file).

The library is built with g++ on a checkout's first graph build (into
benchmark/_build, a fixed directory inside the checkout) and is required:
the graph build raises where it cannot be built.  `build_full_compiled`
runs the whole TLG build in one native call: LG = min(det_log(L o G)),
then T o LG compiled to the device tables of a `CompiledGraph`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from benchmark.graph import fst as pyfst

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fstlib.cpp")
# benchmark/_build: a fixed directory inside the checkout
_LIB_PATH = os.path.join(os.path.dirname(_HERE), "_build", "libfstlib.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> str:
    if os.path.exists(_LIB_PATH) and (
        os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)
    ):
        return _LIB_PATH
    # build under a private name and rename: concurrent processes never
    # load a half-written library
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC,
             "-o", tmp],
            check=True, capture_output=True, timeout=300,
        )
    except subprocess.CalledProcessError as e:
        raise RuntimeError("building the graph library (fstlib.cpp) "
                           f"failed:\n{e.stderr.decode(errors='replace')}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.fstlib_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            lib.fstlib_build_full.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.fstlib_build_full.restype = ctypes.c_int
            _lib = lib
        return _lib


# ---- serialization ----

def pack_fst(f: pyfst.Fst) -> bytes:
    n = f.num_states
    srcs, ils, ols, ws, dsts = [], [], [], [], []
    for s in range(n):
        for a in f.arcs[s]:
            srcs.append(s); ils.append(a.ilabel); ols.append(a.olabel)
            ws.append(a.weight); dsts.append(a.nextstate)
    fin = sorted(f.finals.items())
    parts = [
        np.asarray([n, f.start, len(srcs)], dtype=np.int64).tobytes(),
        np.asarray(srcs, dtype=np.int32).tobytes(),
        np.asarray(ils, dtype=np.int32).tobytes(),
        np.asarray(ols, dtype=np.int32).tobytes(),
        np.asarray(ws, dtype=np.float32).tobytes(),
        np.asarray(dsts, dtype=np.int32).tobytes(),
        np.asarray([len(fin)], dtype=np.int64).tobytes(),
        np.asarray([s for s, _ in fin], dtype=np.int32).tobytes(),
        np.asarray([w for _, w in fin], dtype=np.float32).tobytes(),
    ]
    return b"".join(parts)


def build_full_compiled(
    t: pyfst.Fst, l: pyfst.Fst, g: pyfst.Fst,
    max_degree: int, hub_threshold: int, build_closure: bool,
):
    """The whole graph build -- LG = min(det_log(L o G)), then T o LG
    compiled to device tables -- in ONE native call.  Only T/L/G cross
    the Python boundary; the multi-million-arc LG/TLG intermediates
    stay in C++."""
    lib = _get_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = lib.fstlib_build_full(
        pack_fst(t), pack_fst(l), pack_fst(g),
        max_degree, hub_threshold, int(build_closure),
        ctypes.byref(out), ctypes.byref(out_len),
    )
    if rc != 0:
        raise RuntimeError(f"fstlib_build_full failed rc={rc}")
    try:
        buf = ctypes.string_at(out, out_len.value)
    finally:
        lib.fstlib_free(out)
    return _parse_compiled(buf)


def _parse_compiled(buf: bytes):
    """Decode the fstlib compiled-graph buffer into a CompiledGraph."""
    from benchmark.graph.graph_compile import CompiledGraph

    hdr = np.frombuffer(buf, np.int64, 12)
    (n, start, ee, en, h, eh, has_clo, ec,
     max_e, max_n, depth, max_c) = (int(x) for x in hdr)
    off = 96

    def take(dtype, count):
        nonlocal off
        a = np.frombuffer(buf, dtype, count, off).copy()
        off += count * 4
        return a

    emit_offsets = take(np.int32, n + 1)
    emit_il = take(np.int32, ee)
    emit_ol = take(np.int32, ee)
    emit_w = take(np.float32, ee)
    emit_dst = take(np.int32, ee)
    eps_offsets = take(np.int32, n + 1)
    eps_ol = take(np.int32, en)
    eps_w = take(np.float32, en)
    eps_dst = take(np.int32, en)
    final = take(np.float32, n)
    hub_src = take(np.int32, h)
    hub_offsets = take(np.int32, h + 1)
    hub_packed = take(np.int32, eh * 4).reshape(-1, 4)
    g = CompiledGraph(
        num_states=n, start=start,
        emit_offsets=emit_offsets, emit_ilabel=emit_il, emit_olabel=emit_ol,
        emit_weight=emit_w, emit_dst=emit_dst,
        eps_offsets=eps_offsets, eps_olabel=eps_ol, eps_weight=eps_w,
        eps_dst=eps_dst, final_weight=final,
        max_emit_degree=max_e, max_eps_degree=max_n, eps_depth=depth,
        hub_src=hub_src, hub_offsets=hub_offsets, hub_packed=hub_packed,
    )
    if has_clo:
        g.closure_offsets = take(np.int32, n + 1)
        g.closure_packed = take(np.int32, ec * 4).reshape(-1, 4)
        g.max_closure_degree = max_c
    return g
