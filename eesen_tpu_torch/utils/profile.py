"""Profiling: per-op wall-time accumulation + device trace capture
(counterpart of eesen_tpu/utils/profile.py).

Mirrors the reference's CuDevice profiling (reference:
src/gpucompute/cuda-device.{h,cc}:85-90,323-365 — AccuProfile accumulates
per-op elapsed time into a map, PrintProfile dumps it sorted with memory
stats; enabled in training/inference epilogues).  `Profiler` is host code
and keeps the JAX package's text format.  `trace()` wraps
torch.profiler, where the JAX package wraps jax.profiler: a Chrome trace
that Perfetto or TensorBoard opens.

`profiler.track(name)` is also the port's span: the training loop and the
search mark their layer boundaries with it (the names in `SPANS`).  A
span adds its wall nanoseconds and a count under its name (`track(name,
n)` adds n: one replay of a captured block of n search frames); inside
`trace()` it is also a `record_function` range of the same name, so that
it lands in the Chrome trace beside the kernels it launched.  Under any
other torch.profiler session (a benchmark's own) it opens no range: four
ranges a search frame would add their cost to the traced frame.
`utils/stages.launch_counts()` reads the spans' totals.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterable, Iterator, Optional

import torch

from eesen_tpu_torch.utils.logging import get_logger

log = get_logger("utils.profile")

# The port's spans, each with what reads it (PERF.md §3).  Host wall time:
# a span that launches kernels ends when its launches are queued, and one
# that reads a device value waits for the kernels before it.
SPANS = (
    "train.input_copy",      # run_epoch: the batch to the device
    "train.step",            # run_epoch: the train_step / eval_step call
    "train.forward",         # apply_model in a train or CV step
    "train.loss",            # ctc_loss / ce_loss
    "train.backward",        # torch.autograd.grad
    "train.optimizer",       # clip + update (_update)
    "train.metrics_wait",    # run_epoch: the host reading step t-1's
    #                          obj_sum and frames
    "train.monitor",         # run_epoch: the token-error counts
    "decode.compact",        # compact_blank_frames
    "decode.search",         # make_beam_decoder's decode / decode_chunk
    "decode.frame",          # one frame of the frame loop (a replayed
    #                          block of n frames: its time once, count n)
    "decode.expand",         # a frame's arc expansion + acoustic lookup
    "decode.merge",          # a frame's emit merge (_dedup / _topk_prune)
    "decode.closure",        # a frame's epsilon phase (these three on
    #                          the eager frames only)
    "decode.traceback",      # traceback: copies to the host + the walk
    "model.subsample",       # a Conformer's x4 convolutional subsampling
    "conformer.ffn",         # each of a Conformer layer's two feed-forward
    #                          blocks, LayerNorm included
    "conformer.attention",   # a layer's relative-position attention block
    "conformer.conv",        # a layer's convolution module
)

# The search's CUDA graph counters (decoder/beam.py), beside the spans in
# utils/stages.launch_counts(): the frames run by replaying a captured
# block of frames, and the blocks captured.
graph_counts = {"search_graph_frames": 0, "search_graph_captures": 0}

_now = time.perf_counter_ns
_ranges = 0     # open trace() blocks: spans open record_function ranges


class _Span:
    """One `Profiler.track` call: wall nanoseconds and a count of `n`
    under `key`, and a `record_function` range inside `trace()` (its cost
    inside the span's time)."""

    __slots__ = ("prof", "key", "n", "t0", "rf")

    def __init__(self, prof: "Profiler", key: str, n: int) -> None:
        self.prof = prof
        self.key = key
        self.n = n
        self.rf = None

    def __enter__(self) -> None:
        self.t0 = _now()
        if _ranges:
            self.rf = torch.profiler.record_function(self.key)
            self.rf.__enter__()

    def __exit__(self, *exc) -> None:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.prof.add_ns(self.key, _now() - self.t0, self.n)


class Profiler:
    """Accumulating wall-clock profiler (CuDevice::AccuProfile): each
    key's total in integer nanoseconds (`ns`) and its count; the keys of
    `names` stay present at zero, resets included."""

    def __init__(self, names: Iterable[str] = ()) -> None:
        self.names = tuple(names)
        self.ns: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}
        self.reset()

    @property
    def totals(self) -> Dict[str, float]:
        """Each key's total in seconds."""
        return {k: v / 1e9 for k, v in self.ns.items()}

    def track(self, key: str, n: int = 1) -> _Span:
        """Time the `with` block under `key` (a span) and count it n
        times."""
        return _Span(self, key, n)

    def add_ns(self, key: str, ns: int, n: int = 1) -> None:
        self.ns[key] = self.ns.get(key, 0) + ns
        self.counts[key] = self.counts.get(key, 0) + n

    def accumulate(self, key: str, seconds: float) -> None:
        self.add_ns(key, round(seconds * 1e9))

    def print_profile(self) -> str:
        """Sorted dump (CuDevice::PrintProfile), returned and logged."""
        totals = self.totals
        lines = ["-----\n[profile]:"]
        for key, total in sorted(totals.items(), key=lambda kv: kv[1]):
            lines.append(
                f"{key}\t{total:.6f}s\t(n={self.counts[key]})"
            )
        lines.append(
            f"Total GPU-equivalent time: {sum(totals.values()):.4f}s"
        )
        out = "\n".join(lines)
        log.info("%s", out)
        return out

    def reset(self) -> None:
        self.ns = dict.fromkeys(self.names, 0)
        self.counts = dict.fromkeys(self.names, 0)


# module-level default, like the CuDevice singleton; the spans' home
profiler = Profiler(SPANS)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record the block with torch.profiler and write its Chrome trace to
    `log_dir`/trace.json (Perfetto, TensorBoard): CPU activity, and CUDA
    activity where CUDA is available; the spans as ranges of their
    names."""
    global _ranges
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        _ranges += 1
        try:
            yield prof
        finally:
            _ranges -= 1
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def memory_stats(device="cuda") -> Optional[dict]:
    """Live device memory stats (CuDevice's free/used memory printout):
    torch.cuda.memory_stats for a CUDA device, None for the CPU.  An error
    on a CUDA device is raised, not swallowed."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device)
