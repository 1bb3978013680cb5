"""Cells cut to a size the CPU runs in seconds, for the tests: the
configuration, traffic and limits of a real cell with small widths and
few utterances (the real files are never changed)."""

from __future__ import annotations

import copy
import os

from benchmark import common
from benchmark.graph import build

TOY_GRAPH = dict(vocab=200, lm_sentences=2000)


def train_cell(name: str = "wsj_phn.train", f32: bool = True):
    c = copy.deepcopy(common.cell(name))
    c["config"].update(input_dim=6, cell_dim=8, num_layers=2, num_targets=7)
    if f32:
        c["config"].update(compute_dtype="float32")
    c["traffic"].update(utterances=40, mean_s=0.3, min_s=0.1, max_s=0.6,
                        trace_steps=1,
                        batch={"num_sequence": 8, "frame_limit": 400,
                               "time_quant": 16})
    if name.startswith("librispeech"):
        c["traffic"].update(mean_s=0.9, min_s=0.3, max_s=1.8)
    return c


def decode_cell(tmp_dir: str, name: str = "wsj_phn.decode_lm"):
    """A toy decode cell and the directory of its small graph."""
    c = copy.deepcopy(common.cell(name))
    c["config"]["decode_graph"].update(TOY_GRAPH)
    c["traffic"].update(utterances=12, mean_s=0.8, min_s=0.3, max_s=1.5,
                        batch=4, check_utterances=5)
    c["traffic"]["search"].update(max_active=64)
    gdir = os.path.join(tmp_dir, "graph")
    if not os.path.exists(os.path.join(gdir, "meta.json")):
        os.makedirs(gdir, exist_ok=True)
        build.build_into(c["config"]["decode_graph"], gdir)
    return c, gdir
