"""The search options of the port's beam decoder (eesen_tpu_torch/decoder/
beam.py) on the CPU against the JAX package's decoder with its XLA sort
path (pallas_dedup="never"), on the tiny TLG of tests/test_beam.py:
scan_unroll, approx_top_k, acoustic_gather, compact arc budgets, the
light_* dedup modes and hub graphs.  Live slots are compared as sorted
(state, score) pairs (`canon`), overflow and tracebacks exactly, except
where XLA on the CPU fuses the JAX package's arithmetic into an FMA
(the acoustic gather, the hub lanes): there scores and costs agree to
rtol 1e-6 and states, words and overflow exactly (`assert_close`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.decoder import beam as jbeam
from eesen_tpu.decoder.graph_compile import compile_graph
from eesen_tpu_torch.decoder import beam as tbeam

from tests.test_torch_beam import batch, canon, run_both, tlg, to_port_graph

assert tlg  # the module-scoped fixture, used by name below

SEARCH = dict(beam=12.0, max_active=32, acoustic_scale=0.9)


def assert_same(out_j, out_t, g, lens):
    assert canon(out_t.states, out_t.scores) == \
        canon(out_j.states, out_j.scores)
    np.testing.assert_array_equal(out_t.overflow.numpy(),
                                  np.asarray(out_j.overflow))
    assert tbeam.traceback(out_t, lens, g.final_weight) == \
        jbeam.traceback(out_j, lens, g.final_weight)


def assert_close(out_j, out_t, g, lens, rtol=1e-6):
    """`assert_same` with scores and costs within rtol: where XLA on the
    CPU fuses a multiply and an add into one FMA (one rounding, not two),
    the JAX package's scores may differ from the port's in the last bit.
    The live states, the overflow and the words stay exact."""
    got, want = (canon(o.states, o.scores) for o in (out_t, out_j))
    for row_g, row_w in zip((r for f in got for r in f),
                            (r for f in want for r in f)):
        assert [s for s, _ in row_g] == [s for s, _ in row_w]
        np.testing.assert_allclose([c for _, c in row_g],
                                   [c for _, c in row_w], rtol=rtol)
    np.testing.assert_array_equal(out_t.overflow.numpy(),
                                  np.asarray(out_j.overflow))
    for (w, c), (w_j, c_j) in zip(
            tbeam.traceback(out_t, lens, g.final_weight),
            jbeam.traceback(out_j, lens, g.final_weight)):
        assert w == w_j
        np.testing.assert_allclose(c, c_j, rtol=rtol)


def port_decode(g, ll, lens, dense, **cfg):
    tg = to_port_graph(g)
    return tbeam.make_beam_decoder(tg, tbeam.BeamSearchConfig(**cfg))(
        ll, lens, tbeam.DeviceGraph.put(tg, dense=dense, device="cpu"))


@pytest.mark.parametrize("unroll", [2, 4, 100])
def test_scan_unroll_matches_jax(monkeypatch, tlg, unroll):
    """tests/test_beam.py:215: the unrolled JAX scan against the port,
    which takes the field and changes nothing (bit-equal to unroll 1)."""
    lang, fst = tlg
    g = compile_graph(fst, max_degree=8, build_closure=True)
    ll, lens = batch(lang, seed=17)
    out_j, out_t = run_both(monkeypatch, g, ll, lens, False, **SEARCH,
                            scan_unroll=unroll)
    assert_same(out_j, out_t, g, lens)
    base = port_decode(g, ll, lens, False, **SEARCH)
    for a, b in zip(out_t, base):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("funnel_mult", [0, 1])
def test_approx_top_k_matches_jax(monkeypatch, tlg, funnel_mult):
    """JAX's approx_max_k on its sort path against the port's exact top-k
    (on the CPU the JAX call is exact too)."""
    lang, fst = tlg
    g = compile_graph(fst, max_degree=4, build_closure=False)
    ll, lens = batch(lang, seed=5)
    out_j, out_t = run_both(monkeypatch, g, ll, lens, False, beam=10.0,
                            max_active=16, approx_top_k=True,
                            funnel_mult=funnel_mult)
    assert_same(out_j, out_t, g, lens)


@pytest.mark.parametrize("dense", [False, True])
def test_acoustic_gather_matches_jax(monkeypatch, tlg, dense):
    """JAX's gather route against the port's one lookup.  XLA on the CPU
    fuses that route's multiply and add into an FMA, so scores agree to
    rtol 1e-6 there, not bit for bit (`assert_close`)."""
    lang, fst = tlg
    g = compile_graph(fst, max_degree=4, build_closure=True)
    ll, lens = batch(lang)
    out_j, out_t = run_both(monkeypatch, g, ll, lens, dense, **SEARCH,
                            acoustic_gather=True)
    assert_close(out_j, out_t, g, lens)
    # the port's field changes nothing
    base = port_decode(g, ll, lens, dense, **SEARCH)
    for a, b in zip(out_t, base):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("closure", [False, True])
def test_generous_arc_budgets_match_jax(monkeypatch, tlg, closure):
    """tests/test_beam.py:451: budgets of K x the degree cap always fit:
    overflow 0, the JAX package's slots, and the rectangular search's
    live sets and best paths."""
    lang, fst = tlg
    g = compile_graph(fst, max_degree=8, build_closure=closure)
    ll, lens = batch(lang, seed=23)
    k = SEARCH["max_active"]
    d_x = g.max_closure_degree if closure else g.max_eps_degree
    out_j, out_t = run_both(
        monkeypatch, g, ll, lens, False, **SEARCH,
        arc_budget_emit=k * g.max_emit_degree, arc_budget_x=k * max(d_x, 1))
    assert_same(out_j, out_t, g, lens)
    assert int(out_t.overflow.sum()) == 0
    np.testing.assert_array_equal(out_t.states.numpy(),
                                  np.asarray(out_j.states))
    np.testing.assert_array_equal(out_t.parent.numpy(),
                                  np.asarray(out_j.parent))
    rect = port_decode(g, ll, lens, False, **SEARCH)
    assert canon(out_t.states, out_t.scores) == \
        canon(rect.states, rect.scores)
    assert tbeam.traceback(out_t, lens, g.final_weight) == \
        tbeam.traceback(rect, lens, g.final_weight)


@pytest.mark.parametrize("closure", [False, True])
def test_small_arc_budgets_count_overflow_like_jax(monkeypatch, tlg,
                                                   closure):
    """tests/test_beam.py:489: budgets below the active set's degree drop
    arcs; the overflow counts equal the JAX package's and are > 0."""
    lang, fst = tlg
    g = compile_graph(fst, max_degree=8, build_closure=closure)
    ll, lens = batch(lang, seed=24)
    out_j, out_t = run_both(monkeypatch, g, ll, lens, False, beam=1e9,
                            max_active=4, acoustic_scale=0.9,
                            arc_budget_emit=4, arc_budget_x=4)
    assert_same(out_j, out_t, g, lens)
    assert (out_t.overflow.numpy() > 0).all()


def test_arc_budgets_are_ignored_by_the_dense_layout(monkeypatch, tlg):
    lang, fst = tlg
    g = compile_graph(fst, max_degree=8, build_closure=True)
    ll, lens = batch(lang)
    out_j, out_t = run_both(monkeypatch, g, ll, lens, True, **SEARCH,
                            arc_budget_emit=4, arc_budget_x=4)
    assert_same(out_j, out_t, g, lens)
    want = port_decode(g, ll, lens, True, **SEARCH)
    for a, b in zip(out_t, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["light_emit_dedup", "light_closure_dedup",
                                  "light_eps_dedup"])
@pytest.mark.parametrize("closure", [False, True])
@pytest.mark.parametrize("dense", [False, True])
def test_light_dedup_matches_jax(monkeypatch, tlg, mode, closure, dense):
    """Each light mode on a closure and a no-closure graph.  The closure
    mode acts only on a closure graph and the eps mode only without one
    (a no-op in both packages otherwise)."""
    lang, fst = tlg
    g = compile_graph(fst, max_degree=4, build_closure=closure)
    ll, lens = batch(lang, seed=7)
    out_j, out_t = run_both(monkeypatch, g, ll, lens, dense, **SEARCH,
                            eps_iters=3, **{mode: True})
    assert_same(out_j, out_t, g, lens)
    noop = (mode == "light_closure_dedup" and not closure) or (
        mode == "light_eps_dedup" and closure)
    if noop:
        want = port_decode(g, ll, lens, dense, **SEARCH, eps_iters=3)
        for a, b in zip(out_t, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_light_modes_together_match_jax(monkeypatch, tlg):
    lang, fst = tlg
    g = compile_graph(fst, max_degree=4, build_closure=True)
    ll, lens = batch(lang, seed=9)
    out_j, out_t = run_both(monkeypatch, g, ll, lens, False, **SEARCH,
                            light_emit_dedup=True, light_closure_dedup=True)
    assert_same(out_j, out_t, g, lens)


def hub_graph(fst, closure):
    g = compile_graph(fst, max_degree=8, hub_threshold=3,
                      build_closure=closure)
    assert g.has_hubs
    return g


@pytest.mark.parametrize("closure", [False, True])
@pytest.mark.parametrize("dense", [False, True])
def test_hub_graphs_match_jax(monkeypatch, tlg, closure, dense):
    """tests/test_beam.py:150: hub lanes after the gathered ones, on both
    layouts, with and without the closure; the best paths equal the
    graph without hubs.  XLA on the CPU fuses the hub lanes' score
    arithmetic into an FMA, so scores agree to rtol 1e-6
    (`assert_close`)."""
    lang, fst = tlg
    g = hub_graph(fst, closure)
    ll, lens = batch(lang, seed=11)
    out_j, out_t = run_both(monkeypatch, g, ll, lens, dense, **SEARCH)
    assert_close(out_j, out_t, g, lens)
    dg = tbeam.DeviceGraph.put(to_port_graph(g), dense=dense, device="cpu")
    assert dg.hub_packed.shape == (int(g.hub_offsets[-1]), 8)
    assert dg.hub_of_arc.shape[0] == dg.hub_packed.shape[0]
    plain = compile_graph(fst, max_degree=8, build_closure=closure)
    want = port_decode(plain, ll, lens, dense, beam=1e9, max_active=256)
    got = port_decode(g, ll, lens, dense, beam=1e9, max_active=256)
    for (w, c), (w_p, c_p) in zip(
            tbeam.traceback(got, lens, g.final_weight),
            tbeam.traceback(want, lens, plain.final_weight)):
        assert w == w_p
        np.testing.assert_allclose(c, c_p, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("closure", [False, True])
def test_hubs_with_arc_budgets_match_jax(monkeypatch, tlg, closure):
    """Compact lanes first, then the hub lanes; generous and small
    budgets (scores to rtol 1e-6, `assert_close`)."""
    lang, fst = tlg
    g = hub_graph(fst, closure)
    ll, lens = batch(lang, seed=13)
    for budget in (SEARCH["max_active"] * 8, 4):
        out_j, out_t = run_both(monkeypatch, g, ll, lens, False, **SEARCH,
                                arc_budget_emit=budget, arc_budget_x=budget)
        assert_close(out_j, out_t, g, lens)


def test_hub_streaming_decoder_matches_one_shot(tlg):
    """A hub graph through StreamingBeamDecoder in chunks of 4 frames:
    the one-shot decode's words and costs, and the JAX package's
    streaming decoder's."""
    lang, fst = tlg
    g = hub_graph(fst, True)
    tg = to_port_graph(g)
    ll, lens = batch(lang, seed=15)
    cfg = tbeam.BeamSearchConfig(**SEARCH)
    one = tbeam.traceback(tbeam.make_beam_decoder(tg, cfg)(
        ll, lens, tbeam.DeviceGraph.put(tg, device="cpu")), lens,
        g.final_weight)
    dec = tbeam.StreamingBeamDecoder(tg, cfg, device="cpu")
    jdec = jbeam.StreamingBeamDecoder(
        g, jbeam.BeamSearchConfig(pallas_dedup="never", **SEARCH))
    st, jst = dec.start(ll.shape[0]), jdec.start(ll.shape[0])
    t = ll.shape[1]
    for t0 in range(0, t, 4):
        t1 = min(t0 + 4, t)
        act = np.arange(t0, t1)[None, :] < lens[:, None]
        st = dec.accept(st, ll[:, t0:t1], act)
        jst = jdec.accept(jst, jnp.asarray(ll[:, t0:t1]), act)
        assert dec.partial(st) == jdec.partial(jst)
    for (w, c), (w_o, c_o), (w_j, c_j) in zip(dec.finish(st), one,
                                              jdec.finish(jst)):
        assert w == w_o == w_j
        np.testing.assert_allclose(c, c_o, rtol=1e-6)
        np.testing.assert_allclose(c, c_j, rtol=1e-5)


def test_expand_compact_matches_jax():
    """`_expand_compact` alone on random offsets and degrees (dead slots,
    zero degrees, a budget that overflows): every output equal."""
    rng = np.random.default_rng(0)
    b, k, n_arcs = 3, 6, 40
    packed = rng.integers(0, 30, (n_arcs, 8)).astype(np.int32)
    packed[:, 2] = rng.standard_normal(n_arcs).astype(np.float32).view(
        np.int32)
    offs = np.zeros((b, k, 4), np.int32)
    offs[..., 2] = rng.integers(0, n_arcs - 5, (b, k))
    offs[..., 3] = rng.integers(0, 5, (b, k))
    scores = rng.standard_normal((b, k)).astype(np.float32)
    scores[0, 2] = scores[1, 0] = np.inf
    for m in (8, 30):
        want = jbeam._expand_compact(jnp.asarray(offs), jnp.asarray(scores),
                                     jnp.asarray(packed), 1, m)
        got = tbeam._expand_compact(torch.from_numpy(offs),
                                    torch.from_numpy(scores),
                                    torch.from_numpy(packed), 1, m)
        for name, gv, wv in zip(("dst", "score", "il", "ol", "d_offs",
                                 "src", "overflow"), got, want):
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv),
                                          err_msg=f"m={m} {name}")
