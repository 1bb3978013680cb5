"""The program's counters, and per-stage records of a run: wall seconds,
kernel launches, span seconds and peak device memory of each stage (the
end-to-end examples' results.json).

    stages = Stages()
    with stages("train") as rec:
        run.train(...)
        rec["epochs"] = ...            # anything else the stage records
    stages.rec["train"]    # {"seconds", "launches", "graphs", "spans",
                           #  "peak_gb", ...}
"""

from __future__ import annotations

import contextlib
import json
import time

import torch

from eesen_tpu_torch.ops import (
    beam_cuda, ctc_cuda, lstm_cuda, lstm_v1_cuda, rel_attention,
)
from eesen_tpu_torch.utils.profile import SPANS, graph_counts, profiler


def launch_counts():
    """Every counter of the program, as integers, each key in every
    snapshot: the kernel wrappers' launch counters (`kernel_launches`),
    the search's CUDA graph counters (`utils.profile.graph_counts`) and,
    for each span of `utils.profile.SPANS`, its total wall nanoseconds
    under "span_ns:<name>" and its count under "span_n:<name>"."""
    out = {**kernel_launches(), **graph_counts}
    for name in SPANS:
        out[f"span_ns:{name}"] = profiler.ns[name]
        out[f"span_n:{name}"] = profiler.counts[name]
    return out


def kernel_launches():
    """The kernel wrappers' launch counters (ops/*_cuda.py) and the calls
    of the relative-position attention ops (ops/rel_attention.py)."""
    return {"lstm_fwd": lstm_cuda.launches,
            "lstm_bwd": lstm_cuda.bwd_launches,
            "lstm_scan_fwd": lstm_v1_cuda.launches,
            "lstm_scan_bwd": lstm_v1_cuda.bwd_launches,
            "ctc_alpha": ctc_cuda.alpha_launches,
            "ctc_beta": ctc_cuda.beta_launches,
            "dedup_prune": beam_cuda.launches,
            "rel_attention_fwd": rel_attention.fwd_calls,
            "rel_attention_bwd": rel_attention.bwd_calls}


class Stages:
    """Wall seconds, kernel launches, the search's graph counters and span
    seconds (those that moved) and peak device memory of each stage,
    kept in `rec` and printed as the stage ends.
    CUDA is synchronized and its peak read only once the process has
    initialised it, so a run that stops before any device work never
    initialises it."""

    def __init__(self):
        self.rec = {}

    @contextlib.contextmanager
    def __call__(self, name):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before, ns0 = kernel_launches(), dict(profiler.ns)
        graphs0 = dict(graph_counts)
        t0 = time.perf_counter()
        rec = self.rec[name] = {}
        yield rec
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        after = kernel_launches()
        rec["seconds"] = time.perf_counter() - t0
        rec["launches"] = {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
        rec["graphs"] = {k: v - graphs0[k] for k, v in graph_counts.items()
                         if v != graphs0[k]}
        rec["spans"] = {k: (profiler.ns[k] - ns0[k]) * 1e-9
                        for k in SPANS if profiler.ns[k] != ns0[k]}
        if torch.cuda.is_initialized():
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"stage {name}: {json.dumps(rec)}", flush=True)
