"""The port's spans (eesen_tpu_torch/utils/profile.py `Profiler.track`,
names in `SPANS`), their counters in utils/stages.launch_counts(), and
their places in the training loop and the search, on the CPU."""

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from eesen_tpu_torch.decoder import beam as tbeam
from eesen_tpu_torch.decoder import frame_skip as tskip
from eesen_tpu_torch.decoder.arpa import arpa_to_fst
from eesen_tpu_torch.decoder.ctc_graph import (
    build_lg, build_tlg, compile_lang,
)
from eesen_tpu_torch.decoder.graph_compile import compile_graph
from eesen_tpu_torch.models.model import AcousticModelConfig
from eesen_tpu_torch.training import trainer as ttrainer
from eesen_tpu_torch.training.optim import OptimizerConfig
from eesen_tpu_torch.utils import profile as tprof
from eesen_tpu_torch.utils import stages as tstages

from tests.test_ctc_graph import ARPA, LEXICON, UNITS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def span_counts():
    return dict(tprof.profiler.counts)


def moved(before, after=None):
    """Span counts that changed since `before`."""
    after = span_counts() if after is None else after
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def test_nested_and_raising_spans_add_their_time_and_count():
    p = tprof.Profiler(("outer",))
    assert p.ns == {"outer": 0} and p.counts == {"outer": 0}
    with p.track("outer"):
        with p.track("inner"):
            time.sleep(0.002)
    assert p.counts == {"outer": 1, "inner": 1}
    assert p.ns["outer"] >= p.ns["inner"] >= 2_000_000
    inner = p.ns["inner"]
    with pytest.raises(RuntimeError):
        with p.track("inner"):
            time.sleep(0.001)
            raise RuntimeError("left by an exception")
    assert p.counts["inner"] == 2 and p.ns["inner"] >= inner + 1_000_000
    assert p.totals["inner"] == pytest.approx(p.ns["inner"] * 1e-9)
    assert all(isinstance(v, int) for v in p.ns.values())
    p.reset()
    assert p.ns == {"outer": 0} and p.counts == {"outer": 0}
    assert p.totals == {"outer": 0.0}


def test_record_function_opens_only_while_the_profiler_records(
        monkeypatch, tmp_path):
    """A span opens a range inside utils/profile.trace, the operator's
    profiler, and none outside a profiler or under another torch.profiler
    session (a benchmark's own traced stretch)."""
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    p = tprof.Profiler()
    with p.track("decode.frame"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with p.track("decode.frame"):
            pass
    assert opened == []
    with tprof.trace(str(tmp_path)):
        with p.track("decode.frame"):
            pass
    assert opened == ["decode.frame"]
    with p.track("decode.frame"):
        pass
    assert opened == ["decode.frame"]
    assert p.counts["decode.frame"] == 4


def test_spans_land_in_the_chrome_trace_with_their_time(tmp_path):
    """Under utils/profile.trace each span call is one event of its name,
    and the events' durations sum to the span's in-memory total."""
    p = tprof.Profiler()
    with tprof.trace(str(tmp_path)):
        for _ in range(3):
            with p.track("train.step"):
                torch.ones(64).add_(1.0)
                time.sleep(0.002)
            with p.track("decode.traceback"):
                time.sleep(0.001)
    with open(tmp_path / "trace.json") as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    for name in ("train.step", "decode.traceback"):
        mine = [e for e in ev if e.get("name") == name]
        assert len(mine) == p.counts[name] == 3, name
        got_us = sum(e["dur"] for e in mine)
        want_us = p.ns[name] / 1e3
        assert abs(got_us - want_us) <= max(0.05 * want_us, 50.0), name


def test_launch_counts_hold_every_span_key_from_the_start():
    """In a fresh process every span key is in the snapshot at zero and
    all values are ints; two snapshots around a first-ever span differ
    by that span alone."""
    code = """
import json
from eesen_tpu_torch.utils.profile import SPANS, profiler
from eesen_tpu_torch.utils.stages import launch_counts
a = launch_counts()
with profiler.track("decode.traceback"):
    pass
b = launch_counts()
print(json.dumps({"spans": list(SPANS), "a": a, "b": b}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    a, b = res["a"], res["b"]
    for name in res["spans"]:
        assert a[f"span_ns:{name}"] == 0 and a[f"span_n:{name}"] == 0
    assert set(tstages.kernel_launches()) <= set(a)
    assert set(tprof.graph_counts) <= set(a)
    assert len(a) == (len(tstages.kernel_launches())
                      + len(tprof.graph_counts) + 2 * len(res["spans"]))
    assert set(b) == set(a)
    assert all(isinstance(v, int) for v in (*a.values(), *b.values()))
    diff = {k: b[k] - a[k] for k in a if b[k] != a[k]}
    assert set(diff) == {"span_ns:decode.traceback",
                         "span_n:decode.traceback"}
    assert diff["span_n:decode.traceback"] == 1
    assert diff["span_ns:decode.traceback"] > 0


def test_stages_keep_launches_and_spans_apart():
    st = tstages.Stages()
    with st("work"):
        with tprof.profiler.track("decode.traceback"):
            time.sleep(0.001)
    rec = st.rec["work"]
    assert rec["launches"] == {}                 # no kernel on the CPU
    assert rec["graphs"] == {}                   # nor a captured search
    assert list(rec["spans"]) == ["decode.traceback"]
    assert rec["spans"]["decode.traceback"] >= 1e-3


SMALL = dict(input_dim=6, cell_dim=8, num_layers=2, num_targets=5)


def tiny_batch(seed):
    rng = np.random.default_rng(seed)
    lens = np.array([10, 7, 4], np.int32)
    feats = (0.3 * rng.standard_normal((3, 10, 6))).astype(np.float32)
    labels = rng.integers(1, 5, (3, 2)).astype(np.int32)
    return {"feats": feats, "feat_lengths": lens, "labels": labels,
            "label_lengths": np.array([2, 2, 1], np.int32)}


@pytest.mark.parametrize("train", [True, False])
def test_run_epoch_counts_a_span_a_batch(train):
    cfg = ttrainer.TrainerConfig(
        model=AcousticModelConfig(**SMALL, compute_dtype=torch.float32),
        optimizer=OptimizerConfig(algorithm="sgd", momentum=0.9),
        report_step=2)
    tr = ttrainer.Trainer(cfg, device="cpu")
    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    logger = logging.getLogger("eesen_tpu.training.trainer")
    logger.addHandler(handler)
    try:
        before = span_counts()
        tr.run_epoch(iter([tiny_batch(s) for s in range(3)]), train, 0.01)
        got = moved(before)
    finally:
        logger.removeHandler(handler)
    want = {"train.input_copy": 3, "train.step": 3, "train.metrics_wait": 3,
            "train.monitor": 3, "train.forward": 3, "train.loss": 3}
    if train:
        want.update({"train.backward": 3, "train.optimizer": 3})
    assert got == want
    line = [ln for ln in lines if "batch 2" in ln]
    assert len(line) == 1
    assert "input copy" in line[0] and "metrics wait" in line[0]
    assert "monitor" in line[0]


def test_ter_step_skips_the_monitor_span():
    cfg = ttrainer.TrainerConfig(
        model=AcousticModelConfig(**SMALL, compute_dtype=torch.float32),
        ter_step=1000)
    tr = ttrainer.Trainer(cfg, device="cpu")
    before = span_counts()
    tr.run_epoch(iter([tiny_batch(s) for s in range(2)]), True, 0.01)
    got = moved(before)
    assert "train.monitor" not in got and got["train.metrics_wait"] == 2


@pytest.fixture(scope="module")
def tlg():
    lang = compile_lang(LEXICON, UNITS, dict_type="phn")
    fst = build_tlg(lang.t_fst, build_lg(
        lang.l_fst, arpa_to_fst(ARPA, lang.words)))
    return compile_graph(fst, max_degree=8, build_closure=True)


def loglikes(b=2, t=9, seed=0):
    """Random log-posteriors [B, T, V]: column 0 blank, then the units."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, 1 + len(UNITS))).astype(np.float32)
    return torch.log_softmax(torch.from_numpy(x), dim=-1)


def test_search_counts_a_frame_span_a_searched_frame(tlg):
    dec = tbeam.make_beam_decoder(tlg, tbeam.BeamSearchConfig(
        beam=8.0, max_active=16))
    dg = tbeam.DeviceGraph.put(tlg, device="cpu")
    ll = loglikes()
    lens = np.array([9, 5])
    before = span_counts()
    out = dec(ll, lens, dg)
    assert moved(before) == {"decode.search": 1, "decode.frame": 9,
                             "decode.expand": 9, "decode.merge": 9,
                             "decode.closure": 9}
    before = span_counts()
    for _ in range(2):
        res = tbeam.traceback(out, lens, tlg.final_weight)
    assert moved(before) == {"decode.traceback": 2}
    assert len(res) == 2


def test_compaction_and_chunked_search_count_their_spans(tlg):
    ll = loglikes(t=12, seed=1)
    before = span_counts()
    cf = tskip.compact_blank_frames(ll, torch.tensor([12, 8]), 0.5)
    assert moved(before) == {"decode.compact": 1}
    init_chunk, decode_chunk = tbeam.make_beam_decoder(
        tlg, tbeam.BeamSearchConfig(beam=8.0, max_active=16),
        _internals=True)
    dg = tbeam.DeviceGraph.put(tlg, device="cpu")
    carry, _ = init_chunk(2, dg)
    before = span_counts()
    decode_chunk(carry, cf.loglikes, torch.ones(cf.loglikes.shape[:2],
                                                dtype=torch.bool), dg)
    t = cf.loglikes.shape[1]
    assert moved(before) == {"decode.search": 1, "decode.frame": t,
                             "decode.expand": t, "decode.merge": t,
                             "decode.closure": t}


CONFORMER = dict(input_dim=16, d_model=32, n_layers=2, n_heads=4,
                 conv_kernel_size=5, subsampling_conv_channels=16,
                 num_targets=7)
CONFORMER_SPANS = ("model.subsample", "conformer.ffn", "conformer.attention",
                   "conformer.conv")


def test_conformer_spans_and_op_counters_are_there_from_the_start():
    """The four Conformer spans are in SPANS, so their keys are in every
    snapshot at zero (test_launch_counts_hold_every_span_key_from_the_
    start), and the attention ops' two counters are kernel counters."""
    assert set(CONFORMER_SPANS) <= set(tprof.SPANS)
    a = tstages.launch_counts()
    for name in CONFORMER_SPANS:
        assert f"span_ns:{name}" in a and f"span_n:{name}" in a
    for key in ("rel_attention_fwd", "rel_attention_bwd"):
        assert key in tstages.kernel_launches() and isinstance(a[key], int)


@pytest.mark.parametrize("train", [True, False])
def test_conformer_step_counts_its_spans_and_ops_once_a_layer(train):
    """A Conformer step through run_epoch: the subsampling once, each
    layer's attention and convolution module once and its two
    feed-forward blocks twice; the attention op forward once a layer,
    and in training its backward once a layer."""
    from eesen_tpu_torch.models.conformer import ConformerConfig

    n = CONFORMER["n_layers"]
    cfg = ttrainer.TrainerConfig(
        model=ConformerConfig(**CONFORMER, compute_dtype=torch.float32),
        optimizer=OptimizerConfig(algorithm="adamw", max_grad=0.0))
    tr = ttrainer.Trainer(cfg, device="cpu")
    rng = np.random.default_rng(0)
    b = {"feats": rng.standard_normal((2, 40, 16)).astype(np.float32),
         "feat_lengths": np.array([40, 29], np.int32),
         "labels": np.array([[1, 2, 3], [4, 5, 0]], np.int32),
         "label_lengths": np.array([3, 2], np.int32)}
    before, k0 = span_counts(), tstages.kernel_launches()
    tr.run_epoch(iter([dict(b), dict(b)]), train, 1e-3)
    got = moved(before)
    k1 = tstages.kernel_launches()
    assert {k: got[k] for k in CONFORMER_SPANS} == {
        "model.subsample": 2, "conformer.ffn": 2 * 2 * n,
        "conformer.attention": 2 * n, "conformer.conv": 2 * n}
    assert k1["rel_attention_fwd"] - k0["rel_attention_fwd"] == 2 * n
    assert k1["rel_attention_bwd"] - k0["rel_attention_bwd"] == (
        2 * n if train else 0)
    assert k1["lstm_fwd"] == k0["lstm_fwd"]
