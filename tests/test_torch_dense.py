"""The port's dense Viterbi decoder (eesen_tpu_torch/decoder/dense.py) on
the CPU against the JAX package's (eesen_tpu/decoder/dense.py) and the
port's host FasterDecoder at an infinite beam: the four cases of
tests/test_dense.py on its toy TLG with in-degree caps of 4 (hubs)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from eesen_tpu.decoder import dense as jd
from eesen_tpu.decoder.arpa import arpa_to_fst as j_arpa
from eesen_tpu.decoder.ctc_graph import build_lg as j_lg
from eesen_tpu.decoder.ctc_graph import build_tlg as j_tlg
from eesen_tpu.decoder.ctc_graph import compile_lang as j_lang
from eesen_tpu.decoder.graph_compile import compile_graph as j_compile
from eesen_tpu_torch.decoder import beam as tbeam
from eesen_tpu_torch.decoder import dense as td
from eesen_tpu_torch.decoder.arpa import arpa_to_fst
from eesen_tpu_torch.decoder.ctc_graph import build_lg, build_tlg, compile_lang
from eesen_tpu_torch.decoder.faster import FasterDecoder, FasterDecoderOptions
from eesen_tpu_torch.decoder.graph_compile import compile_graph

from tests.test_beam import synth_loglikes
from tests.test_ctc_graph import ARPA, LEXICON, UNITS

SEQS = [
    ["a", "<blk>", "b", "<blk>", "b", "a"],
    ["a", "a", "b", "c", "<blk>"],
    ["b", "a", "<blk>", "a", "b"],
    ["c", "<blk>", "b", "a", "a"],
]
RTOL, ATOL = 1e-4, 1e-3      # tests/test_dense.py's cost tolerance


@pytest.fixture(scope="module")
def graphs():
    """(lang, port tlg, port CompiledGraph, port DenseGraph, JAX
    DenseGraph): both packages build the same graph from the same text."""
    lang = compile_lang(LEXICON, UNITS, dict_type="phn")
    tlg = build_tlg(lang.t_fst, build_lg(lang.l_fst, arpa_to_fst(
        ARPA, lang.words)))
    cg = compile_graph(tlg, max_degree=8, build_closure=True)
    dg = td.build_dense_graph(cg, in_degree=4, closure_in_degree=4)
    jl = j_lang(LEXICON, UNITS, dict_type="phn")
    jcg = j_compile(j_tlg(jl.t_fst, j_lg(jl.l_fst, j_arpa(ARPA, jl.words))),
                    max_degree=8, build_closure=True)
    jdg = jd.build_dense_graph(jcg, in_degree=4, closure_in_degree=4)
    return lang, tlg, cg, dg, jdg


def oracle(tlg):
    return FasterDecoder(tlg, FasterDecoderOptions(
        beam=1e9, max_active=10**9, acoustic_scale=0.9))


def both(dg, jdg, ll, lens):
    """(port DenseOutputs, JAX DenseOutputs, port results, JAX results)."""
    out = td.make_dense_decoder(dg, 0.9)(
        ll, lens, td.DenseDeviceGraph.put(dg, device="cpu"))
    jout = jd.make_dense_decoder(jdg, 0.9)(
        jnp.asarray(ll), jnp.asarray(lens), jd.DenseDeviceGraph.put(jdg))
    res = td.traceback_dense(out, out.final_scores, lens, dg)
    jres = jd.traceback_dense(jout, np.asarray(jout.final_scores), lens, jdg)
    return out, jout, res, jres


def assert_same(res, jres):
    for (w, c), (jw, jc) in zip(res, jres):
        assert w == jw
        np.testing.assert_allclose(c, jc, rtol=RTOL, atol=ATOL)


def test_dense_graph_has_hubs(graphs):
    """The caps force hub tables, and the port's host build gives the JAX
    package's tables array for array."""
    _, _, _, dg, jdg = graphs
    assert len(dg.ehub_state) > 0 or len(dg.chub_state) > 0
    for f in dataclasses.fields(td.DenseGraph):
        a, b = getattr(dg, f.name), getattr(jdg, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), f.name)


@pytest.mark.parametrize("seed", range(4))
def test_dense_matches_jax_and_faster_decoder(graphs, seed):
    lang, tlg, _, dg, jdg = graphs
    ll = synth_loglikes(np.random.default_rng(seed), lang, SEQS[seed],
                        t_per=2, noise=1.0)[None].astype(np.float32)
    lens = np.asarray([ll.shape[1]])
    out, jout, res, jres = both(dg, jdg, ll, lens)
    # noise keeps the candidates tie-free: every table equal
    for f in td.DenseOutputs._fields:
        np.testing.assert_array_equal(
            getattr(out, f).numpy(), np.asarray(getattr(jout, f)), f)
    assert_same(res, jres)
    _, ref_words, ref_cost = oracle(tlg).decode(ll[0])
    assert res[0][0] == ref_words
    np.testing.assert_allclose(res[0][1], ref_cost, rtol=RTOL, atol=ATOL)
    assert td.decode_dense(
        ll, lens, dg, td.DenseDeviceGraph.put(dg, device="cpu"), 0.9
    ) == res


def test_dense_batched_lengths(graphs):
    """Batched rows with different lengths (and a zero-length row) decode
    independently, as in JAX and as the oracle alone."""
    lang, tlg, _, dg, jdg = graphs
    rng = np.random.default_rng(42)
    lls = [
        synth_loglikes(rng, lang, ["a", "<blk>", "b"], t_per=2),
        synth_loglikes(rng, lang, ["b", "a", "<blk>", "a", "b", "c"],
                       t_per=2),
    ]
    t_max = max(len(x) for x in lls)
    ll = np.full((3, t_max, lls[0].shape[1]), -30.0, np.float32)
    lens = np.asarray([len(lls[0]), len(lls[1]), 0], np.int32)
    for i, x in enumerate(lls):
        ll[i, : len(x)] = x
    out, jout, res, jres = both(dg, jdg, ll, lens)
    np.testing.assert_array_equal(out.final_scores.numpy(),
                                  np.asarray(jout.final_scores))
    assert_same(res, jres)
    assert res[2] == ([], 0.0)
    for i, x in enumerate(lls):
        _, ref_words, ref_cost = oracle(tlg).decode(x)
        assert res[i][0] == ref_words
        np.testing.assert_allclose(res[i][1], ref_cost, rtol=RTOL, atol=ATOL)


def test_dense_matches_beam(graphs):
    """Dense and the port's beam search agree at a wide beam, and the
    dense padding frames (lp -30) leave no NaN in the scores."""
    lang, _, cg, dg, jdg = graphs
    ll = synth_loglikes(np.random.default_rng(7), lang,
                        ["a", "a", "b", "c"], t_per=2, noise=1.0)[None]
    ll = np.concatenate([ll, np.full((1, 3, ll.shape[2]), -30.0,
                                     np.float32)], axis=1)
    lens = np.asarray([ll.shape[1] - 3])
    out, _, res, jres = both(dg, jdg, ll, lens)
    assert not np.isnan(out.final_scores.numpy()).any()
    assert_same(res, jres)
    dec = tbeam.make_beam_decoder(cg, tbeam.BeamSearchConfig(
        beam=1e9, max_active=256, acoustic_scale=0.9))
    (bw, bc), = tbeam.traceback(
        dec(ll, lens, tbeam.DeviceGraph.put(cg, device="cpu")), lens,
        cg.final_weight)
    assert res[0][0] == bw
    np.testing.assert_allclose(res[0][1], bc, rtol=RTOL, atol=ATOL)
