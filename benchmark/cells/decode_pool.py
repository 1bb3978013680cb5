"""A decode cell: the `latgen` composition over the pool's chunks.

Each chunk goes as `tools/cli.cmd_latgen` and `recipes/run.run_search`
send it: the host log-posteriors to the device, `compact_blank_frames`,
the beam decoder of `make_beam_decoder` on `DeviceGraph.put(
CompiledGraph.load(...))` (a chunk whose word buffer overflowed is
searched again with twice the buffer), then `traceback` on the host.
Set-up loads the cached graph (graph/build.py builds it on a checkout's
first run), makes the traffic and warms up on the longest chunk.  The
window serves chunks in a seeded order; it closes at the end of the
chunk that was running when `seconds` had passed.

`decode_audio_s_per_s` is the audio of every utterance of the chunks
that completed in the window over the window's wall time.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import common
from benchmark.graph import build
from benchmark.reference import search as ref
from benchmark.reference.quant import no_tf32
from benchmark.traffic import decode_pool

# the reference's two rules for equal scores (reference/search.py)
TIE_RULES = ("lane", "state")


class Cell:
    def __init__(self, c: Dict, seed: int, device, tracer=None,
                 fault: Optional[str] = None, graph_dir: Optional[str] = None,
                 warm: bool = True):
        from eesen_tpu_torch.decoder.beam import (
            BeamSearchConfig, DeviceGraph, make_beam_decoder,
        )
        from eesen_tpu_torch.decoder.graph_compile import CompiledGraph

        self.c, self.seed, self.device = c, seed, device
        self.cfg, self.spec = c["config"], c["traffic"]
        self.tracer = tracer or common.Tracer(False)
        self.fault = fault
        s = self.spec["search"]
        with common.stage("graph_cache"):
            self.graph_dir = graph_dir or build.ensure(self.cfg,
                                                       c["config_path"])
        with common.stage("traffic"):
            prons = np.load(os.path.join(self.graph_dir, "prons.npy"))
            self.chunks = decode_pool.make(self.spec, self.cfg, prons, seed,
                                           device)
        self.order = decode_pool.serve_order(len(self.chunks), seed,
                                             self.spec["strata"])
        with common.stage("graph_load"):
            self.graph = CompiledGraph.load(
                os.path.join(self.graph_dir, "tlg.npz"))
            self.dg = DeviceGraph.put(self.graph, device=device)
            self.bcfg = BeamSearchConfig(
                beam=s["beam"], max_active=s["max_active"],
                funnel_mult=s["funnel_mult"],
                acoustic_scale=s["acoustic_scale"],
                blank_skip=s["blank_skip"],
                blank_skip_bucket=s["blank_skip_bucket"])
            self.decoder = make_beam_decoder(self.graph, self.bcfg)
        if not warm:
            return
        with common.stage("warm_up"):
            self.serve(0)
            self.tracer.warm()
            if str(device).startswith("cuda"):
                torch.cuda.synchronize()

    def serve(self, ci: int) -> Dict:
        """One chunk through the latgen composition."""
        from eesen_tpu_torch.decoder.beam import make_beam_decoder, traceback
        from eesen_tpu_torch.decoder.frame_skip import compact_blank_frames

        ch = self.chunks[ci]
        lp = torch.from_numpy(ch.lp).to(self.device)
        cf = compact_blank_frames(lp, torch.from_numpy(ch.lengths).to(
            self.device), self.bcfg.blank_skip,
            bucket=self.bcfg.blank_skip_bucket)
        lens = cf.lengths.cpu().numpy()
        out = self.decoder(cf.loglikes, lens, self.dg)
        if int(out.overflow.sum()) > 0:
            wide = dataclasses.replace(
                self.bcfg, max_olabels=self.bcfg.max_olabels * 2)
            out = make_beam_decoder(self.graph, wide)(cf.loglikes, lens,
                                                      self.dg)
        res = traceback(out, lens, self.graph.final_weight)
        if self.fault == "token":
            w, cost = res[0]
            res[0] = ([x + 1 for x in w[:1]] + w[1:] or [1], cost)
        return {"chunk": ci, "results": res, "kept": cf.loglikes,
                "kept_lengths": lens, "searched": int(cf.loglikes.shape[1])}

    def window(self, seconds: float, min_chunks: int = 0,
               first=()) -> Dict:
        """Serve chunks for `seconds` (at least `min_chunks`, the chunks
        `first` before the seeded order)."""
        n_trace = self.spec["trace_chunks"]
        t_first = 1
        tracer = self.tracer
        done: List[Dict] = []
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        i = 0
        first = list(first)
        while time.perf_counter() - t0 < seconds or i < min_chunks or (
                tracer.enabled and i <= t_first + n_trace):
            if tracer.enabled and i == t_first:
                tracer.start()
            if tracer.enabled and i == t_first + n_trace:
                tracer.stop()
            ci = first.pop(0) if first else next(self.order)
            if tracer.enabled and t_first <= i < t_first + n_trace:
                tracer.mark(f"chunk{i}")
            r = self.serve(ci)
            r["traced"] = tracer.enabled and t_first <= i < t_first + n_trace
            done.append(r)
            i += 1
        window_s = time.perf_counter() - t0
        frames = sum(int(self.chunks[r["chunk"]].lengths.sum()) for r in done)
        return {"window_s": window_s, "done": done, "chunks": len(done),
                "attempted": sum(int((self.chunks[r["chunk"]].utts >= 0)
                                     .sum()) for r in done),
                "frames": frames,
                "audio_s": frames * self.cfg["frame_s"],
                "kept_frames": sum(int(r["kept_lengths"].sum())
                                   for r in done)}

    def end_to_end(self, stats: Dict) -> Dict:
        return {"decode_audio_s_per_s": {
            "value": stats["audio_s"] / stats["window_s"],
            "unit": "audio-s/s"}}

    def sample(self, stats: Dict) -> List[tuple]:
        """(result, row) pairs to check: the longest utterance served and
        `check_utterances` more drawn from the seed."""
        rows = [(ri, j) for ri, r in enumerate(stats["done"])
                for j in range(len(r["results"]))
                if self.chunks[r["chunk"]].utts[j] >= 0]
        longest = max(rows, key=lambda x: int(
            self.chunks[stats["done"][x[0]]["chunk"]].lengths[x[1]]))
        rng = np.random.default_rng([self.seed, 3])
        n = min(self.spec["check_utterances"], len(rows))
        pick = [rows[int(i)] for i in rng.choice(len(rows), n, replace=False)]
        return [longest] + [p for p in pick if p != longest]

    def check(self, stats: Dict, mode: str = "program") -> Dict:
        return self.check_modes(stats, (mode,))[mode]

    def check_modes(self, stats: Dict, modes) -> Dict[str, Dict]:
        """The compared numbers of the sampled utterances: the
        compaction's lengths and kept log-likelihoods, and each
        utterance's words and cost, of the program (mode "program") or of
        the reference in bfloat16 put in its place ("control"), against
        the reference (its cost under either tie rule)."""
        s = self.spec["search"]
        pick = self.sample(stats)
        done = stats.pop("done")
        lps, lens, prog_kept, prog = [], [], [], []
        for ri, j in pick:
            r = done[ri]
            ch = self.chunks[r["chunk"]]
            lps.append(ch.lp[j])
            lens.append(int(ch.lengths[j]))
            nk = int(r["kept_lengths"][j])
            prog_kept.append(r["kept"][j, :nk].cpu().numpy())
            prog.append(r["results"][j])
        del done
        self.dg = self.decoder = None
        gc.collect()
        if str(self.device).startswith("cuda"):
            torch.cuda.empty_cache()
        no_tf32()
        g = ref.Graph(os.path.join(self.graph_dir, "tlg.npz"), self.device)
        kept = [ref.compact(x, n, s["blank_skip"]) for x, n in zip(lps, lens)]
        wants = [ref.search(g, kept, s, "f32", self.device, ties)
                 for ties in TIE_RULES]
        out = {}
        for mode in modes:
            if mode == "program":
                got, got_kept = prog, prog_kept
            else:
                got_kept = [ref.compact(x, n, s["blank_skip"], "bf16")
                            for x, n in zip(lps, lens)]
                got = ref.search(g, got_kept, s, "bf16", self.device, "lane")
            costs = ref.word_costs(g, kept, [w for w, _ in got], s,
                                   device=self.device)
            out[mode] = compare(got, wants, got_kept, kept, costs)
        return out


def compare(got, wants, got_kept, want_kept, word_cost) -> Dict:
    """kept_length_mismatch: utterances whose compacted length differs;
    kept_lp_gap: the widest gap of a kept log-likelihood; cost_gap: the
    widest relative gap of the best-path cost, against the nearer of the
    references `wants` (one a tie rule); word_cost_gap: the widest
    relative gap between the cost stated with the words and the least
    cost of those words on the same frames."""
    len_mismatch = sum(len(a) != len(b) for a, b in zip(got_kept, want_kept))
    lp_gap = max((float(np.abs(a - b).max()) for a, b in
                  zip(got_kept, want_kept) if len(a) == len(b) and len(a)),
                 default=0.0)
    cost_gap = max(min(abs(a[1] - b[1]) / max(1.0, abs(b[1])) for b in bs)
                   for a, *bs in zip(got, *wants))
    word_gap = max(abs(c - a[1]) / max(1.0, abs(a[1]))
                   for a, c in zip(got, word_cost))
    return {"kept_length_mismatch": float(len_mismatch),
            "kept_lp_gap": lp_gap, "cost_gap": cost_gap,
            "word_cost_gap": word_gap}
