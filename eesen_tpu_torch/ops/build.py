"""Build and load the port's CUDA kernels.

Every `.cu` file under `eesen_tpu_torch/csrc/` that holds a kernel is
compiled by `nvcc` for `sm_90a` (Hopper) into an object, all sources at
once in parallel, and the objects are linked into ONE shared library with
a plain C interface, `eesen_tpu_torch/_build/libeesen_kernels.so`, which
is loaded with `ctypes`.  Nothing includes PyTorch's headers, so a cold
build takes seconds.  The build runs at first use (never at import) and
is reused while it is newer than every source and header.

    from eesen_tpu_torch.ops import build
    lib = build.load()          # builds if needed; raises if nvcc fails
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from typing import List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = (
    "lstm_fwd.cu", "lstm_bwd.cu", "gemm_wgmma.cu", "lstm_scan_fwd.cu",
    "lstm_scan_bwd.cu",
    "ctc_alpha_beta.cu", "dedup_prune.cu", "cuda_errors.cu",
)
LIB_PATH = os.path.join(BUILD_DIR, "libeesen_kernels.so")
# Opt-in shared memory of a block on the H100, in bytes: the host plans'
# limit and, through -DEESEN_SMEM_LIMIT, the kernels' own.
SMEM_LIMIT = 232448
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", f"-DEESEN_SMEM_LIMIT={SMEM_LIMIT}",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "from eesen_tpu_torch/csrc at first use"
        )
    return found


def _inputs() -> List[str]:
    """Every file the library is built from: SOURCES and the headers
    (`*.cuh`) they include."""
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    return [os.path.join(CSRC_DIR, f) for f in (*SOURCES, *headers)]


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(f) > built for f in _inputs())


def build(verbose: bool = False) -> str:
    """Compile the kernels into LIB_PATH if it is missing or stale.

    One nvcc process per source, all started together, then one link.
    A file lock keeps concurrent processes from building at once; the
    library is written under a private name and renamed into place."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if not _stale():
                return LIB_PATH
            cc = nvcc()
            extra = ["-Xptxas", "-v"] if verbose else []
            objs: List[str] = []
            procs = []
            for src in SOURCES:
                obj = os.path.join(BUILD_DIR, src.replace(".cu", ".o"))
                objs.append(obj)
                procs.append((src, subprocess.Popen(
                    [cc, *NVCC_FLAGS, *extra, "-c",
                     os.path.join(CSRC_DIR, src), "-o", obj],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )))
            failed = []
            for src, p in procs:
                out, _ = p.communicate()
                if verbose and out:
                    print(out, flush=True)
                if p.returncode != 0:
                    failed.append(f"{src}:\n{out}")
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
            subprocess.run(
                [cc, "-shared", "-o", tmp, *objs],
                check=True, capture_output=True, text=True,
            )
            os.replace(tmp, LIB_PATH)
            return LIB_PATH
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  Every pointer
    and the stream are passed as c_void_p, every size as c_int; each
    entry returns its cudaGetLastError() as an int."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.lstm_fwd.argtypes = [_P] * 12 + [_I] * 10 + [_P]
        lib.lstm_fwd.restype = _I
        lib.lstm_fwd_smem_bytes.argtypes = [_I] * 5
        lib.lstm_fwd_smem_bytes.restype = ctypes.c_longlong
        lib.lstm_fwd_max_clusters.argtypes = [_I] * 7
        lib.lstm_fwd_max_clusters.restype = _I
        lib.lstm_bwd.argtypes = [_P] * 21 + [_I] * 12 + [_P]
        lib.lstm_bwd.restype = _I
        lib.lstm_bwd_smem_bytes.argtypes = [_I] * 5
        lib.lstm_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.lstm_bwd_max_clusters.argtypes = [_I] * 7
        lib.lstm_bwd_max_clusters.restype = _I
        lib.gemm_bf16.argtypes = ([_P] + [_I] * 2 + [_P] + [_I] * 3
                                  + [_P, _I, _P] + [_I] * 4 + [_P])
        lib.gemm_bf16.restype = _I
        lib.gemm_bf16_kslice.argtypes = [_I] * 2
        lib.gemm_bf16_kslice.restype = _I
        lib.gemm_bf16_smem_bytes.argtypes = []
        lib.gemm_bf16_smem_bytes.restype = _I
        for name in ("lstm_scan_fwd", "lstm_scan_bwd"):
            getattr(lib, name).argtypes = [_P] * 8 + [_I] * 5 + [_P]
            getattr(lib, name).restype = _I
            getattr(lib, f"{name}_smem_bytes").argtypes = [_I] * 2
            getattr(lib, f"{name}_smem_bytes").restype = ctypes.c_longlong
            getattr(lib, f"{name}_rec").argtypes = [_P] * 8 + [_I] * 7 + [_P]
            getattr(lib, f"{name}_rec").restype = _I
        lib.lstm_scan_bwd_max_clusters.argtypes = [_I] * 6
        lib.lstm_scan_bwd_max_clusters.restype = _I
        lib.ctc_alpha.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        lib.ctc_alpha.restype = _I
        lib.ctc_beta.argtypes = [_P] * 5 + [_I] * 3 + [_P]
        lib.ctc_beta.restype = _I
        lib.ctc_depth.argtypes = [_I]
        lib.ctc_depth.restype = _I
        lib.ctc_smem_bytes.argtypes = [_I] * 2
        lib.ctc_smem_bytes.restype = ctypes.c_longlong
        lib.dedup_prune.argtypes = [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P]
        lib.dedup_prune.restype = _I
        lib.dedup_prune_ready.argtypes = [_I] * 2
        lib.dedup_prune_ready.restype = _I
        lib.dedup_prune_smem_bytes.argtypes = [_I] * 2
        lib.dedup_prune_smem_bytes.restype = ctypes.c_longlong
        lib.cuda_error_string.argtypes = [_I]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry reported a CUDA error."""
    if err != 0:
        msg = load().cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
