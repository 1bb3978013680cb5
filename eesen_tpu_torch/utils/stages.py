"""Per-stage records of a run: wall seconds, kernel launches and peak
device memory of each stage (the end-to-end examples' results.json).

    stages = Stages()
    with stages("train") as rec:
        run.train(...)
        rec["epochs"] = ...            # anything else the stage records
    stages.rec["train"]                # {"seconds", "launches", "peak_gb", ...}
"""

from __future__ import annotations

import contextlib
import json
import time

import torch

from eesen_tpu_torch.ops import beam_cuda, ctc_cuda, lstm_cuda, lstm_v1_cuda


def launch_counts():
    """The kernel wrappers' launch counters (ops/*_cuda.py)."""
    return {"lstm_fwd": lstm_cuda.launches,
            "lstm_bwd": lstm_cuda.bwd_launches,
            "lstm_scan_fwd": lstm_v1_cuda.launches,
            "lstm_scan_bwd": lstm_v1_cuda.bwd_launches,
            "ctc_alpha": ctc_cuda.alpha_launches,
            "ctc_beta": ctc_cuda.beta_launches,
            "dedup_prune": beam_cuda.launches}


class Stages:
    """Wall seconds, kernel launches (those that moved) and peak device
    memory of each stage, kept in `rec` and printed as the stage ends.
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
        before = launch_counts()
        t0 = time.perf_counter()
        rec = self.rec[name] = {}
        yield rec
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        after = launch_counts()
        rec["seconds"] = time.perf_counter() - t0
        rec["launches"] = {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
        if torch.cuda.is_initialized():
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"stage {name}: {json.dumps(rec)}", flush=True)
