"""The port's WFST beam search (eesen_tpu_torch/decoder/beam.py) on the CPU
against the JAX package's decoder with its XLA sort path
(pallas_dedup="never"), on the tiny TLG of tests/test_beam.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.decoder import beam as jbeam
from eesen_tpu.decoder.arpa import arpa_to_fst
from eesen_tpu.decoder.ctc_graph import build_lg, build_tlg, compile_lang
from eesen_tpu.decoder.graph_compile import compile_graph
from eesen_tpu_torch.decoder import beam as tbeam
from eesen_tpu_torch.decoder import graph_compile as t_gc

from tests.test_beam import synth_loglikes
from tests.test_ctc_graph import ARPA, LEXICON, UNITS

SEQS = [
    ["a", "<blk>", "b", "<blk>", "b", "a"],
    ["a", "a", "b", "c", "<blk>"],
    ["b", "a", "<blk>", "a", "b"],
]


@pytest.fixture(scope="module")
def tlg():
    lang = compile_lang(LEXICON, UNITS, dict_type="phn")
    lg = build_lg(lang.l_fst, arpa_to_fst(ARPA, lang.words))
    return lang, build_tlg(lang.t_fst, lg)


def batch(lang, seed=3):
    """B=3 utterances of unequal length; noise keeps scores tie-free."""
    rng = np.random.default_rng(seed)
    lls = [synth_loglikes(rng, lang, s, t_per=2, noise=1.0) for s in SEQS]
    t_max = max(len(x) for x in lls)
    ll = np.zeros((len(lls), t_max, lls[0].shape[1]), np.float32)
    lens = np.array([len(x) for x in lls], np.int32)
    for i, x in enumerate(lls):
        ll[i, : len(x)] = x
    return ll, lens


def to_port_graph(g):
    """The JAX package's CompiledGraph as the port's, field for field."""
    return t_gc.CompiledGraph(**{
        f.name: getattr(g, f.name)
        for f in dataclasses.fields(t_gc.CompiledGraph)
    })


def canon(states, scores):
    """Per (frame, row): sorted (state, score) pairs of live slots."""
    st, sc = np.asarray(states), np.asarray(scores)
    return [[
        sorted(zip(st[t, b][np.isfinite(sc[t, b])].tolist(),
                   sc[t, b][np.isfinite(sc[t, b])].tolist()))
        for b in range(st.shape[1])] for t in range(st.shape[0])]


def run_both(monkeypatch, g, ll, lens, dense, **cfg):
    budget = 1 << 40 if dense else 0
    monkeypatch.setattr(jbeam, "DENSE_ROWS_BUDGET", budget)
    monkeypatch.setattr(tbeam, "DENSE_ROWS_BUDGET", budget)
    jcfg = jbeam.BeamSearchConfig(pallas_dedup="never", **cfg)
    tcfg = tbeam.BeamSearchConfig(**cfg)
    out_j = jbeam.make_beam_decoder(g, jcfg)(
        jnp.asarray(ll), jnp.asarray(lens), jbeam.DeviceGraph.put(g)
    )
    tg = to_port_graph(g)
    dg = tbeam.DeviceGraph.put(tg, device="cpu")
    assert (dg.emit_rows.shape[0] > 0) == dense
    out_t = tbeam.make_beam_decoder(tg, tcfg)(ll, lens, dg)
    return out_j, out_t


@pytest.mark.parametrize("closure", [False, True])
@pytest.mark.parametrize("dense", [False, True])
def test_decoder_matches_jax(monkeypatch, tlg, closure, dense):
    lang, fst = tlg
    g = compile_graph(fst, max_degree=4, build_closure=closure)
    ll, lens = batch(lang)
    out_j, out_t = run_both(monkeypatch, g, ll, lens, dense, beam=12.0,
                            max_active=32, acoustic_scale=0.9)
    assert out_t.states.shape == np.asarray(out_j.states).shape
    assert canon(out_t.states, out_t.scores) == \
        canon(out_j.states, out_j.scores)
    np.testing.assert_array_equal(out_t.overflow.numpy(),
                                  np.asarray(out_j.overflow))
    res_j = jbeam.traceback(out_j, lens, g.final_weight)
    res_t = tbeam.traceback(out_t, lens, g.final_weight)
    for (w_t, c_t), (w_j, c_j) in zip(res_t, res_j):
        assert w_t == w_j
        np.testing.assert_allclose(c_t, c_j, rtol=1e-6)


@pytest.mark.parametrize("cfg", [
    dict(funnel_mult=1),
    dict(sort_active=True),
    dict(lattice_beam=3.0, max_olabels=1),
    dict(eps_iters=2),
])
def test_decoder_options_match_jax(monkeypatch, tlg, cfg):
    lang, fst = tlg
    g = compile_graph(fst, max_degree=4, build_closure=False)
    ll, lens = batch(lang, seed=5)
    out_j, out_t = run_both(monkeypatch, g, ll, lens, False, beam=10.0,
                            max_active=16, **cfg)
    assert canon(out_t.states, out_t.scores) == \
        canon(out_j.states, out_j.scores)
    np.testing.assert_array_equal(out_t.overflow.numpy(),
                                  np.asarray(out_j.overflow))
    np.testing.assert_array_equal(out_t.lat_mask.numpy().sum(-1),
                                  np.asarray(out_j.lat_mask).sum(-1))
    if cfg.get("sort_active"):
        st = out_t.states.numpy()
        key = np.where(st < 0, np.iinfo(np.int32).max, st)
        assert (np.diff(key, axis=-1) >= 0).all()
    assert tbeam.traceback(out_t, lens, g.final_weight) == \
        jbeam.traceback(out_j, lens, g.final_weight)


def test_outputs_convert_to_numpy(tlg):
    lang, fst = tlg
    g = to_port_graph(compile_graph(fst, max_degree=4))
    ll, lens = batch(lang)
    out = tbeam.make_beam_decoder(g, tbeam.BeamSearchConfig(
        max_active=8, max_olabels=3))(ll, lens, tbeam.DeviceGraph.put(
            g, device="cpu"))
    npo = out.numpy()
    t_max, b = ll.shape[1], ll.shape[0]
    assert npo.states.shape == (t_max, b, 8) and npo.states.dtype == np.int32
    assert npo.olabels.shape == (t_max, b, 8, 3)
    assert npo.init_olabels.shape == (b, 8, 3)
    assert npo.overflow.shape == (b,) and npo.lat_mask.dtype == bool


def test_blank_skip_leaves_the_search_unchanged(tlg):
    """The decoder takes blank_skip and, as the JAX package's, ignores it
    (the callers compact), so its search equals the one without it."""
    g = to_port_graph(compile_graph(tlg[1], max_degree=4))
    cfg = tbeam.BeamSearchConfig(blank_skip=0.5)
    ll, lens = batch(tlg[0])
    dg = tbeam.DeviceGraph.put(g, device="cpu")
    got = tbeam.make_beam_decoder(g, cfg)(ll, lens, dg)
    want = tbeam.make_beam_decoder(g)(ll, lens, dg)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_layout_mismatch_raises(monkeypatch, tlg):
    g = to_port_graph(compile_graph(tlg[1], max_degree=4))
    dec = tbeam.make_beam_decoder(g, tbeam.BeamSearchConfig(max_active=8))
    ll, lens = batch(tlg[0])
    with pytest.raises(ValueError):
        dec(ll, lens, tbeam.DeviceGraph.put(g, dense=False, device="cpu"))
    assert torch.is_tensor(dec(ll, lens, tbeam.DeviceGraph.put(
        g, device="cpu")).states)
