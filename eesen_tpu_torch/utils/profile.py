"""Profiling: per-op wall-time accumulation + device trace capture
(counterpart of eesen_tpu/utils/profile.py).

Mirrors the reference's CuDevice profiling (reference:
src/gpucompute/cuda-device.{h,cc}:85-90,323-365 — AccuProfile accumulates
per-op elapsed time into a map, PrintProfile dumps it sorted with memory
stats; enabled in training/inference epilogues).  `Profiler` is host code
and keeps the JAX package's text format.  `trace()` wraps
torch.profiler, where the JAX package wraps jax.profiler: a Chrome trace
that Perfetto or TensorBoard opens.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

from eesen_tpu_torch.utils.logging import get_logger

log = get_logger("utils.profile")


class Profiler:
    """Accumulating wall-clock profiler (CuDevice::AccuProfile)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def track(self, key: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[key] = self.totals.get(key, 0.0) + dt
            self.counts[key] = self.counts.get(key, 0) + 1

    def accumulate(self, key: str, seconds: float) -> None:
        self.totals[key] = self.totals.get(key, 0.0) + seconds
        self.counts[key] = self.counts.get(key, 0) + 1

    def print_profile(self) -> str:
        """Sorted dump (CuDevice::PrintProfile), returned and logged."""
        lines = ["-----\n[profile]:"]
        for key, total in sorted(self.totals.items(), key=lambda kv: kv[1]):
            lines.append(
                f"{key}\t{total:.6f}s\t(n={self.counts[key]})"
            )
        lines.append(
            f"Total GPU-equivalent time: {sum(self.totals.values()):.4f}s"
        )
        out = "\n".join(lines)
        log.info("%s", out)
        return out

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


# module-level default, like the CuDevice singleton
profiler = Profiler()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record the block with torch.profiler and write its Chrome trace to
    `log_dir`/trace.json (Perfetto, TensorBoard): CPU activity, and CUDA
    activity where CUDA is available."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def memory_stats(device="cuda") -> Optional[dict]:
    """Live device memory stats (CuDevice's free/used memory printout):
    torch.cuda.memory_stats for a CUDA device, None for the CPU.  An error
    on a CUDA device is raised, not swallowed."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device)
