"""The search loop in captured blocks (eesen_tpu_torch/decoder/beam.py:
`graph_block`, `_FrameGraph`, `make_beam_decoder`'s `run_frames`).

On the CPU: the block plan, `Profiler.track(name, n)`, the graph counters
in utils/stages.launch_counts(), the eager loop of a CPU search, and the
block loop's bookkeeping with a stand-in for the CUDA graph (a "capture"
that replays by running the block again).  On the card (marker `cuda`,
skipped without one): replayed blocks against the eager loop, bit for
bit, on every route of the frame step.  This file imports neither jax nor
the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_search_graph.py
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from eesen_tpu_torch.decoder import beam as tbeam
from eesen_tpu_torch.decoder.arpa import arpa_to_fst
from eesen_tpu_torch.decoder.ctc_graph import build_lg, build_tlg, compile_lang
from eesen_tpu_torch.decoder.graph_compile import compile_graph
from eesen_tpu_torch.recipes.lm import estimate_bigram_arpa
from eesen_tpu_torch.recipes.synth_corpus import SynthConfig, make_lexicon
from eesen_tpu_torch.utils import profile as tprof
from eesen_tpu_torch.utils import stages as tstages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_graph(hub_threshold=0):
    """A 20-word bigram TLG over 5 phones (vocabulary of 6 columns)."""
    scfg = SynthConfig(num_phones=5, num_words=20)
    rng = np.random.default_rng(1)
    lex = make_lexicon(scfg, rng)
    vocab = [w for w, _ in lex]
    sents = [[vocab[int(j)] for j in rng.integers(0, 20, 4)]
             for _ in range(40)]
    lang = compile_lang(lex, [f"p{i:02d}" for i in range(5)])
    return compile_graph(build_tlg(lang.t_fst, build_lg(
        lang.l_fst, arpa_to_fst(estimate_bigram_arpa(sents, vocab=vocab),
                                lang.words))), max_degree=4,
        hub_threshold=hub_threshold, build_closure=True)


@pytest.fixture(scope="module")
def graph():
    return small_graph()


def loglikes(b, t, seed=0):
    """Log-normalized random frames [B, T, 6] with spikes."""
    rng = np.random.default_rng(seed)
    ll = rng.standard_normal((b, t, 6)).astype(np.float32) * 3.0
    return ll - np.log(np.exp(ll).sum(-1, keepdims=True))


def moved(before):
    after = tstages.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def same_outputs(got, want):
    for name, g, w in zip(tbeam.BeamOutputs._fields, got, want):
        assert torch.equal(g.cpu(), w.cpu()), name


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("t,f", [
    (64, 64), (96, 64), (128, 64), (200, 64), (1, 0), (16, 16), (0, 0),
    (21, 16), (2, 2), (3, 2), (63, 32), (640, 64),
])
def test_graph_block_plan(t, f):
    """The largest power of two from 2 to 64 that is at most T' (0: none,
    the eager loop)."""
    assert tbeam.graph_block(t) == f


def test_graph_block_follows_its_cap(monkeypatch):
    monkeypatch.setattr(tbeam, "MAX_GRAPH_BLOCK", 16)
    assert [tbeam.graph_block(t) for t in (64, 96, 8)] == [16, 16, 8]
    monkeypatch.setattr(tbeam, "MAX_GRAPH_BLOCK", 0)
    assert tbeam.graph_block(64) == 0


def test_track_adds_n_to_the_count():
    p = tprof.Profiler(("decode.frame",))
    with p.track("decode.frame", 64):
        pass
    with p.track("decode.frame"):
        pass
    assert p.counts["decode.frame"] == 65
    assert p.ns["decode.frame"] > 0
    p.add_ns("decode.frame", 10, 3)
    assert p.counts["decode.frame"] == 68


def test_graph_counters_are_present_at_zero_from_import():
    code = """
import json
from eesen_tpu_torch.utils.stages import launch_counts
print(json.dumps(launch_counts()))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["search_graph_frames"] == 0
    assert got["search_graph_captures"] == 0
    assert set(tprof.graph_counts) == {"search_graph_frames",
                                       "search_graph_captures"}


def test_cpu_decode_takes_the_eager_loop(graph):
    dec = tbeam.make_beam_decoder(graph, tbeam.BeamSearchConfig(
        beam=10.0, max_active=32))
    dg = tbeam.DeviceGraph.put(graph, device="cpu")
    ll, lens = loglikes(2, 64), np.array([64, 40])
    for _ in range(3):
        before = tstages.launch_counts()
        dec(ll, lens, dg)
        got = moved(before)
        assert "search_graph_frames" not in got
        assert "search_graph_captures" not in got
        for span in ("frame", "expand", "merge", "closure"):
            assert got[f"span_n:decode.{span}"] == 64


class StandIn:
    """A CUDA graph's stand-in on the CPU: the "capture" runs the block
    once (a real capture only records it) and each replay runs it again
    on the static buffers."""
    made = []

    def __init__(self, fn, dev):
        assert dev.type == "cpu"
        self.fn = fn
        self.resets = 0
        fn()
        StandIn.made.append(self)

    def replay(self):
        self.fn()

    def reset(self):
        self.resets += 1


@pytest.fixture
def stand_in(monkeypatch):
    StandIn.made = []
    monkeypatch.setattr(tbeam, "_graphs_on", lambda dev: True)
    monkeypatch.setattr(tbeam, "_capture", StandIn)
    return StandIn


def eager(monkeypatch, fn):
    with monkeypatch.context() as m:
        m.setattr(tbeam, "MAX_GRAPH_BLOCK", 0)
        return fn()


@pytest.mark.parametrize("t,blocks", [(200, (0, 1, 1)), (24, (0,)),
                                      (16, (0,)), (128, (0, 0)), (1, ())])
def test_blocks_keep_the_eager_bits_and_counts(graph, stand_in, monkeypatch,
                                               t, blocks):
    """A one-shot decode of T' frames: the first block of a shape runs
    eagerly, the next captures where another block follows it in the
    call, the rest replay, and the last T' mod F frames run eagerly.
    Outputs equal the eager loop's; decode.frame counts every frame,
    expand/merge/closure the eager ones only."""
    cfg = tbeam.BeamSearchConfig(beam=10.0, max_active=32, lattice_beam=4.0)
    dg = tbeam.DeviceGraph.put(graph, device="cpu")
    ll, lens = loglikes(3, t, seed=t), np.array([t, t - 5, 3])
    want = eager(monkeypatch,
                 lambda: tbeam.make_beam_decoder(graph, cfg)(ll, lens, dg))
    f = tbeam.graph_block(t)
    before = tstages.launch_counts()
    got = tbeam.make_beam_decoder(graph, cfg)(ll, lens, dg)
    same_outputs(got, want)
    d = moved(before)
    graphed = f * sum(blocks)
    assert len(stand_in.made) == (1 if any(blocks) else 0)
    assert d.get("search_graph_captures", 0) == len(stand_in.made)
    assert d.get("search_graph_frames", 0) == graphed
    assert d["span_n:decode.frame"] == t
    assert d["span_n:decode.expand"] == t - graphed


def test_chunked_search_replays_across_calls(graph, stand_in, monkeypatch):
    """decode_chunk over 16-frame chunks: chunk 1 eager, chunk 2 captures,
    the rest replay; the carry handed back is never the graph's own, and
    every chunk equals the eager loop's."""
    cfg = tbeam.BeamSearchConfig(beam=10.0, max_active=32)
    dg = tbeam.DeviceGraph.put(graph, device="cpu")
    ll = torch.from_numpy(loglikes(2, 64, seed=3))
    act = torch.ones((2, 64), dtype=torch.bool)
    act[1, 50:] = False

    def run():
        init_chunk, decode_chunk = tbeam.make_beam_decoder(
            graph, cfg, _internals=True)
        carry, _ = init_chunk(2, dg)
        outs = []
        for t0 in range(0, 64, 16):
            carry, out = decode_chunk(carry, ll[:, t0:t0 + 16],
                                      act[:, t0:t0 + 16], dg)
            outs.append((carry, out))
        return outs

    want = eager(monkeypatch, run)
    before = tstages.launch_counts()
    stages = tstages.Stages()
    with stages("stream"):
        got = run()
    d = moved(before)
    assert d["search_graph_captures"] == 1
    assert d["search_graph_frames"] == 48
    assert stages.rec["stream"]["graphs"] == {"search_graph_frames": 48,
                                              "search_graph_captures": 1}
    for (c_g, o_g), (c_w, o_w) in zip(got, want):
        for g, w in zip((*c_g, *o_g), (*c_w, *o_w)):
            assert torch.equal(g, w)
    # the graph's carry buffers are one storage; each chunk's carry has
    # its own
    ptrs = [c[0].data_ptr() for c, _ in got]
    assert len(set(ptrs)) == len(ptrs)


def test_a_decoder_keeps_at_most_max_graphs(graph, stand_in, monkeypatch):
    """With room for one graph, a second shape drops the first (reset);
    a config change makes a decoder of its own, with its own graphs."""
    monkeypatch.setattr(tbeam, "MAX_GRAPHS", 1)
    cfg = tbeam.BeamSearchConfig(beam=10.0, max_active=32)
    dg = tbeam.DeviceGraph.put(graph, device="cpu")
    dec = tbeam.make_beam_decoder(graph, cfg)
    for b in (2, 3, 2):
        for _ in range(3):
            dec(loglikes(b, 32, seed=b), np.full(b, 32), dg)
    assert len(stand_in.made) == 3
    assert [g.resets for g in stand_in.made] == [1, 1, 0]
    other = tbeam.make_beam_decoder(graph, dataclasses.replace(cfg, beam=6.0))
    ll, lens = loglikes(2, 32, seed=2), np.full(2, 32)
    want = eager(monkeypatch, lambda: other(ll, lens, dg))
    for _ in range(3):
        got = other(ll, lens, dg)
    same_outputs(got, want)
    assert len(stand_in.made) == 4


# ------------------------------------------------------------ on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# (graph, BeamSearchConfig fields, packed layout, T'): kernel 2 on every
# merge (K=512), the sort route (K=5000: 20,000- and 25,000-lane merges),
# the dense and the packed layouts, a hub graph, arc budgets (both merges
# back on kernel 2), the light modes with a sorted active set, T' that are
# no multiple of their block (an eager tail), and three blocks (the first
# call captures)
ROUTES = {
    "kernel2_dense": (0, dict(max_active=512), False, 64),
    "kernel2_packed": (0, dict(max_active=512), True, 64),
    "sort_packed": (0, dict(max_active=5000), True, 32),
    "sort_dense": (0, dict(max_active=5000), False, 32),
    "hub": (4, dict(max_active=512), False, 48),
    "budgets": (0, dict(max_active=5000, arc_budget_emit=5000,
                        arc_budget_x=11000), True, 32),
    "light_sorted": (0, dict(max_active=512, light_emit_dedup=True,
                             light_closure_dedup=True, sort_active=True),
                     True, 32),
    "odd_t": (0, dict(max_active=512), True, 21),
    "three_blocks": (0, dict(max_active=512), True, 200),
}


def route_setup(name, dev, monkeypatch):
    hub, fields, packed, t = ROUTES[name]
    if packed:
        monkeypatch.setattr(tbeam, "DENSE_ROWS_BUDGET", 0)
    g = small_graph(hub_threshold=hub)
    cfg = tbeam.BeamSearchConfig(beam=14.0, acoustic_scale=0.9,
                                 lattice_beam=6.0, **fields)
    dg = tbeam.DeviceGraph.put(g, device=dev)
    ll = torch.from_numpy(loglikes(4, t, seed=7)).to(dev)
    lens = np.array([t, t - 3, t // 2, 1])
    return g, cfg, dg, ll, lens, t


def three_calls_equal_the_eager_loop(name, dev, monkeypatch):
    """Three calls of one decoder (eager, capture, replay) against the
    eager loop: equal bits in every output, kernel 2's count the same
    both ways, decode.frame counting the frames searched."""
    g, cfg, dg, ll, lens, t = route_setup(name, dev, monkeypatch)

    def counted(dec):
        before = tstages.launch_counts()
        out = dec(ll, lens, dg)
        torch.cuda.synchronize()
        return out, moved(before)

    want, d_want = eager(monkeypatch, lambda: counted(
        tbeam.make_beam_decoder(g, cfg)))
    dec = tbeam.make_beam_decoder(g, cfg)
    f = tbeam.graph_block(t)
    n = t // f if f else 0
    # the first call: block 1 eager, block 2 captured where a third
    # follows; every block of a later call replays
    replayed = [f * (n - 1) if n >= 3 else 0, f * n, f * n]
    for call in range(3):
        got, d = counted(dec)
        same_outputs(got, want)
        assert d.get("dedup_prune", 0) == d_want.get("dedup_prune", 0)
        assert d["span_n:decode.frame"] == t
        assert d.get("search_graph_frames", 0) == replayed[call]
    if name.startswith("kernel2") or name in ("hub", "budgets"):
        assert d_want["dedup_prune"] == 1 + 2 * t
    if name.startswith("sort"):
        assert "dedup_prune" not in d_want


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ROUTES))
def test_replayed_blocks_equal_the_eager_loop_on_card(dev, monkeypatch,
                                                      name):
    three_calls_equal_the_eager_loop(name, dev, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kernel2_packed", "three_blocks"])
def test_a_search_off_the_current_device_replays_there(monkeypatch, name):
    """The search on cuda:1 while cuda:0 is current: its captures and
    replays run on cuda:1, with the eager loop's bits there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    captures = tprof.graph_counts["search_graph_captures"]
    three_calls_equal_the_eager_loop(name, torch.device("cuda", 1),
                                     monkeypatch)
    assert tprof.graph_counts["search_graph_captures"] == captures + 1
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_streamed_chunks_replay_on_card(dev, monkeypatch, packed):
    """decode_chunk over 16-frame chunks (F=16): the eager loop's carries
    and outputs, bit for bit."""
    if packed:
        monkeypatch.setattr(tbeam, "DENSE_ROWS_BUDGET", 0)
    g = small_graph()
    cfg = tbeam.BeamSearchConfig(beam=14.0, max_active=512)
    dg = tbeam.DeviceGraph.put(g, device=dev)
    ll = torch.from_numpy(loglikes(3, 96, seed=5)).to(dev)
    act = torch.arange(96, device=dev)[None, :] < torch.tensor(
        [[96], [70], [33]], device=dev)

    def run():
        init_chunk, decode_chunk = tbeam.make_beam_decoder(
            g, cfg, _internals=True)
        carry, _ = init_chunk(3, dg)
        outs = []
        for t0 in range(0, 96, 16):
            carry, out = decode_chunk(carry, ll[:, t0:t0 + 16],
                                      act[:, t0:t0 + 16], dg)
            outs.append([x.clone() for x in (*carry, *out)])
        return outs

    want = eager(monkeypatch, run)
    before = tstages.launch_counts()
    got = run()
    assert moved(before)["search_graph_frames"] == 80
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_replayed_blocks_do_not_synchronize(dev, monkeypatch):
    """Once captured, a chunk of replayed blocks makes no synchronizing
    call; nor does the eager frame step (no host scalar is copied to the
    card inside a frame)."""
    monkeypatch.setattr(tbeam, "DENSE_ROWS_BUDGET", 0)
    g = small_graph()
    cfg = tbeam.BeamSearchConfig(beam=14.0, max_active=512)
    dg = tbeam.DeviceGraph.put(g, device=dev)
    ll = torch.from_numpy(loglikes(4, 64, seed=9)).to(dev)
    act = torch.ones((4, 64), dtype=torch.bool, device=dev)
    init_chunk, decode_chunk = tbeam.make_beam_decoder(g, cfg,
                                                       _internals=True)
    for _ in range(2):                       # eager, then the capture
        decode_chunk(init_chunk(4, dg)[0], ll, act, dg)
    eager_init, eager_chunk = tbeam.make_beam_decoder(g, cfg,
                                                      _internals=True)
    carries = [init_chunk(4, dg)[0], eager_init(4, dg)[0]]
    torch.cuda.synchronize()
    before = tprof.graph_counts["search_graph_frames"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_chunk(carries[0], ll, act, dg)
        with monkeypatch.context() as m:
            m.setattr(tbeam, "MAX_GRAPH_BLOCK", 0)
            eager_chunk(carries[1], ll, act, dg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tprof.graph_counts["search_graph_frames"] == before + 64


@pytest.mark.cuda
def test_decoders_keep_their_own_graphs_on_card(dev, monkeypatch):
    """Two decoders of one graph and shape but other beams: each replays
    its own capture and keeps its own eager bits."""
    g, cfg, dg, ll, lens, t = route_setup("kernel2_packed", dev, monkeypatch)
    other = dataclasses.replace(cfg, beam=8.0)
    want = [eager(monkeypatch, lambda c=c: tbeam.make_beam_decoder(g, c)(
        ll, lens, dg)) for c in (cfg, other)]
    decs = [tbeam.make_beam_decoder(g, c) for c in (cfg, other)]
    captures = tprof.graph_counts["search_graph_captures"]
    for _ in range(3):
        for dec, w in zip(decs, want):
            same_outputs(dec(ll, lens, dg), w)
    assert tprof.graph_counts["search_graph_captures"] == captures + 2
    assert not torch.equal(want[0].scores, want[1].scores) or not \
        torch.equal(want[0].states, want[1].states)
