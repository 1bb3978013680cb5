"""Streaming in the port (eesen_tpu_torch/models/streaming.py, the carried
`_direction_scan`, and decoder/beam.py's chunked search,
compose_chunk_paths and StreamingBeamDecoder) against the JAX package on
the CPU, and against the port's own offline decode, from the same
parameters (params_from_jax); f32 compute."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.decoder import beam as jbeam
from eesen_tpu.decoder.arpa import arpa_to_fst
from eesen_tpu.decoder.ctc_graph import build_lg, build_tlg, compile_lang
from eesen_tpu.decoder.graph_compile import compile_graph
from eesen_tpu.models import bilstm as jbilstm
from eesen_tpu.models import model as jmodel
from eesen_tpu.models import streaming as jstream
from eesen_tpu_torch.decoder import beam as tbeam
from eesen_tpu_torch.decoder import graph_compile as t_gc
from eesen_tpu_torch.models import bilstm as tbilstm
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.models import streaming as tstream

from tests.test_ctc_graph import ARPA, LEXICON, UNITS
from tests.test_frame_skip import _peaked

# tests/test_unilstm.py:25
JCFG = jmodel.AcousticModelConfig(
    input_dim=6, cell_dim=8, num_layers=2, num_targets=5,
    compute_dtype=jnp.float32, bidirectional=False,
)
BCFG = dict(beam=1e9, max_active=256, acoustic_scale=0.9)


def tcfg_of(jcfg):
    return tmodel.AcousticModelConfig(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
           if f.name not in ("compute_dtype", "use_pallas")},
        compute_dtype=torch.float32,
    )


def params_of(jcfg, seed):
    jp = jax.tree_util.tree_map(
        np.asarray, jmodel.init_model(jax.random.PRNGKey(seed), jcfg))
    return jp, tmodel.params_from_jax(jp, device="cpu")


def chunks(t, size):
    return [(t0, min(t0 + size, t)) for t0 in range(0, t, size)]


@pytest.fixture(scope="module")
def graphs():
    lang = compile_lang(LEXICON, UNITS, dict_type="phn")
    fst = build_tlg(lang.t_fst, build_lg(
        lang.l_fst, arpa_to_fst(ARPA, lang.words)))
    g = compile_graph(fst, max_degree=8, build_closure=True)
    tg = t_gc.CompiledGraph(**{f.name: getattr(g, f.name)
                               for f in dataclasses.fields(t_gc.CompiledGraph)})
    return lang, g, tg


def test_uni_model_matches_jax():
    """The unidirectional stack of tests/test_unilstm.py:25 against JAX
    apply_model: f32, sums in another order, atol 1e-5."""
    jp, tp = params_of(JCFG, 1)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 11, 6)).astype(np.float32)
    lens = np.array([11, 8, 5], np.int32)
    want = np.asarray(jmodel.apply_model(jp, jnp.asarray(feats),
                                         jnp.asarray(lens), JCFG))
    got = tmodel.apply_model(tp, torch.from_numpy(feats),
                             torch.from_numpy(lens), tcfg_of(JCFG))
    assert set(tp["layers"][0]) == {"fw"}
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [1, 4, 7, 30])
def test_carried_scan_in_chunks_equals_one_scan(size):
    """_direction_scan with carry_in/return_carry, chunk by chunk, equals
    one zero-state scan (m) and the JAX carried scan (m and the final
    carry), f32 atol 1e-5; rows end inside, at and before chunks."""
    lcfg = jbilstm.BiLstmConfig(input_dim=4, cell_dim=5, bidirectional=False,
                                compute_dtype=jnp.float32, use_pallas="never")
    p = jax.tree_util.tree_map(np.asarray, jbilstm.init_bilstm_layer(
        jax.random.PRNGKey(3), lcfg)["fw"])
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tcfg = tbilstm.BiLstmConfig(input_dim=4, cell_dim=5, bidirectional=False,
                                compute_dtype=torch.float32)
    rng = np.random.default_rng(1)
    t, b = 21, 4
    x = rng.standard_normal((t, b, 4)).astype(np.float32)
    lens = np.array([21, 14, 7, 0])
    mask = (np.arange(t)[:, None] < lens[None]).astype(np.float32)
    one = tbilstm._direction_scan(tp, torch.from_numpy(x),
                                  torch.from_numpy(mask), tcfg)
    carry = (torch.zeros(b, 5), torch.zeros(b, 5))
    jcarry = (jnp.zeros((b, 5)), jnp.zeros((b, 5)))
    for t0, t1 in chunks(t, size):
        m, carry = tbilstm._direction_scan(
            tp, torch.from_numpy(x[t0:t1]), torch.from_numpy(mask[t0:t1]),
            tcfg, None, carry_in=carry, return_carry=True)
        jm, jcarry = jbilstm._direction_scan(
            p, jnp.asarray(x[t0:t1]), jnp.asarray(mask[t0:t1]), lcfg, None,
            carry_in=jcarry, return_carry=True)
        np.testing.assert_allclose(m.numpy(), one[t0:t1].numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0,
                                   atol=1e-5)
        for got, want in zip(carry, jcarry):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5)


def test_stream_step_matches_jax():
    """stream_step chained over uneven chunks equals JAX stream_step
    (logits and carries, 1e-5) and the offline apply_model on the valid
    frames (tests/test_unilstm.py:87)."""
    jp, tp = params_of(JCFG, 2)
    tcfg = tcfg_of(JCFG)
    rng = np.random.default_rng(5)
    b, t = 3, 20
    feats = rng.standard_normal((b, t, 6)).astype(np.float32)
    lengths = np.array([20, 13, 17], np.int32)
    offline = tmodel.apply_model(tp, torch.from_numpy(feats),
                                 torch.from_numpy(lengths), tcfg).numpy()
    sam = tstream.StreamingAcousticModel(tp, tcfg, device="cpu")
    st = sam.start(b)
    jst = jstream.init_stream_state(JCFG, b)
    got = np.zeros_like(offline)
    for t0, t1 in chunks(t, 7):
        cl = np.clip(lengths - t0, 0, t1 - t0)
        logits, st = sam.step(st, feats[:, t0:t1], cl)
        jlog, jst = jstream.stream_step(jp, jst, jnp.asarray(feats[:, t0:t1]),
                                        jnp.asarray(cl), JCFG)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                   rtol=0, atol=1e-5)
        for (c, m), (jc, jm) in zip(st, jst):
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)
        got[:, t0:t1] = logits.numpy()
    for i in range(b):
        np.testing.assert_allclose(got[i, :lengths[i]],
                                   offline[i, :lengths[i]], rtol=0,
                                   atol=1e-5)


def test_streaming_refuses_a_bidirectional_stack(graphs):
    cfg = dataclasses.replace(tcfg_of(JCFG), bidirectional=True)
    with pytest.raises(ValueError):
        tstream.StreamingAcousticModel({}, cfg, device="cpu")
    with pytest.raises(ValueError):
        tstream.StreamingPipeline({}, cfg, graphs[2], device="cpu")
    with pytest.raises(ValueError):
        tstream.stream_step({}, [], torch.zeros((1, 2, 6)),
                            torch.ones(1), cfg)
    with pytest.raises(ValueError):
        tstream.StreamingPipeline(
            {}, tcfg_of(JCFG), graphs[2],
            tbeam.BeamSearchConfig(blank_skip=0.98), device="cpu")


@pytest.mark.parametrize("cap", [1, 3, 16])
@pytest.mark.parametrize("n_olabels", [1, 2])
def test_compose_chunk_paths_matches_jax(cap, n_olabels):
    """Random parents and sparse olabels: every output exact, overflow
    counts included."""
    rng = np.random.default_rng(cap * 10 + n_olabels)
    tc, b, k = 9, 3, 6
    parent = rng.integers(0, k, (tc, b, k)).astype(np.int32)
    olabels = rng.integers(1, 50, (tc, b, k, n_olabels)).astype(np.int32)
    olabels[rng.random(olabels.shape) < 0.6] = 0
    want = jbeam.compose_chunk_paths(jnp.asarray(parent),
                                     jnp.asarray(olabels), cap)
    got = tbeam.compose_chunk_paths(torch.from_numpy(parent),
                                    torch.from_numpy(olabels), cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def offline_decode(tg, lp, lengths, cfg):
    dec = tbeam.make_beam_decoder(tg, cfg)
    out = dec(lp, lengths, tbeam.DeviceGraph.put(tg, device="cpu"))
    return tbeam.traceback(out, lengths, tg.final_weight)


def test_chunked_entry_matches_one_shot(graphs):
    """make_beam_decoder(_internals=True): init_chunk + decode_chunk over
    chunks give the one-shot decode's per-frame outputs, bit for bit."""
    _, _, tg = graphs
    rng = np.random.default_rng(3)
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((2, 13, 1 + len(UNITS))).astype(np.float32) * 3),
        dim=-1)
    lengths = np.array([13, 8])
    cfg = tbeam.BeamSearchConfig(beam=12.0, max_active=32)
    dg = tbeam.DeviceGraph.put(tg, device="cpu")
    out = tbeam.make_beam_decoder(tg, cfg)(lp, lengths, dg)
    init, chunk = tbeam.make_beam_decoder(tg, cfg, _internals=True)
    carry, init_olab = init(2, dg)
    torch.testing.assert_close(init_olab, out.init_olabels, rtol=0, atol=0)
    act = torch.arange(13)[None, :] < torch.from_numpy(lengths)[:, None]
    for t0, t1 in chunks(13, 5):
        carry, (st, sc, par, ol, lm) = chunk(carry, lp[:, t0:t1],
                                             act[:, t0:t1], dg)
        for got, want in ((st, out.states), (sc, out.scores),
                          (par, out.parent), (ol, out.olabels),
                          (lm, out.lat_mask)):
            torch.testing.assert_close(got, want[t0:t1], rtol=0, atol=0)
    torch.testing.assert_close(carry[3], out.overflow, rtol=0, atol=0)


def uni_setup(graphs, seed):
    """tests/test_unilstm.py:187: a uni model over the small TLG, two
    streams of 18 and 12 frames, and the offline lp."""
    _, g, tg = graphs
    jcfg = dataclasses.replace(JCFG, num_targets=1 + len(UNITS))
    jp, tp = params_of(jcfg, 7)
    tcfg = tcfg_of(jcfg)
    rng = np.random.default_rng(seed)
    b, t = 2, 18
    feats = rng.standard_normal((b, t, jcfg.input_dim)).astype(np.float32)
    lengths = np.array([18, 12], np.int32)
    lp = torch.log_softmax(tmodel.apply_model(
        tp, torch.from_numpy(feats), torch.from_numpy(lengths), tcfg), dim=-1)
    return jcfg, jp, tcfg, tp, feats, lengths, lp


def test_streaming_am_and_decoder_match_offline(graphs):
    """StreamingAcousticModel + StreamingBeamDecoder == offline
    apply_model + one-shot decode (tests/test_unilstm.py:187), and the
    JAX package's streaming pair on the same chunks."""
    _, g, tg = graphs
    jcfg, jp, tcfg, tp, feats, lengths, lp = uni_setup(graphs, 11)
    cfg = tbeam.BeamSearchConfig(**BCFG)
    ref = offline_decode(tg, lp, lengths, cfg)
    sam = tstream.StreamingAcousticModel(tp, tcfg, device="cpu")
    dec = tbeam.StreamingBeamDecoder(tg, cfg, device="cpu")
    jdec = jbeam.StreamingBeamDecoder(
        g, jbeam.BeamSearchConfig(pallas_dedup="never", **BCFG))
    ast, dst, jst = sam.start(2), dec.start(2), jdec.start(2)
    for t0, t1 in chunks(18, 5):
        cl = np.clip(lengths - t0, 0, t1 - t0)
        logits, ast = sam.step(ast, feats[:, t0:t1], cl)
        clp = torch.log_softmax(logits, dim=-1)
        act = np.arange(t0, t1)[None, :] < lengths[:, None]
        dst = dec.accept(dst, clp, act)
        jst = jdec.accept(jst, jnp.asarray(clp.numpy()), act)
        assert dec.partial(dst) == jdec.partial(jst)
    res, jres = dec.finish(dst), jdec.finish(jst)
    for (w, c), (w_r, c_r), (w_j, c_j) in zip(res, ref, jres):
        assert w == w_r == w_j
        np.testing.assert_allclose(c, c_r, rtol=1e-5)
        np.testing.assert_allclose(c, c_j, rtol=1e-5)


def test_streaming_decoder_with_blank_skip(graphs):
    """Per-chunk blank-skip on peaked posteriors: the JAX package's
    streaming decoder's words and costs (rtol 1e-5), and the offline full
    decode's words (costs within the skip tolerance of
    tests/test_frame_skip.py)."""
    lang, g, tg = graphs
    rng = np.random.default_rng(7)
    seqs = [["a", "<blk>", "<blk>", "b", "<blk>", "b", "<blk>", "a"],
            ["a", "a", "<blk>", "<blk>", "<blk>", "b", "c", "<blk>"]]
    lls = [_peaked(rng, lang, s, t_per=3) for s in seqs]
    t = max(x.shape[0] for x in lls)
    lp = np.stack([np.pad(x, ((0, t - x.shape[0]), (0, 0)))
                   for x in lls]).astype(np.float32)
    lengths = np.array([x.shape[0] for x in lls])
    full = offline_decode(tg, lp, lengths, tbeam.BeamSearchConfig(**BCFG))
    cfg = tbeam.BeamSearchConfig(blank_skip=0.98, blank_skip_bucket=4, **BCFG)
    dec = tbeam.StreamingBeamDecoder(tg, cfg, device="cpu")
    jdec = jbeam.StreamingBeamDecoder(g, jbeam.BeamSearchConfig(
        pallas_dedup="never", blank_skip=0.98, blank_skip_bucket=4, **BCFG))
    dst, jst = dec.start(2), jdec.start(2)
    for t0, t1 in chunks(t, 12):
        act = np.arange(t0, t1)[None, :] < lengths[:, None]
        dst = dec.accept(dst, lp[:, t0:t1], act)
        jst = jdec.accept(jst, jnp.asarray(lp[:, t0:t1]), act)
    assert dst["tframes"] == jst["tframes"] < t       # merged some
    for (w, c), (w_j, c_j), (w_f, c_f) in zip(dec.finish(dst),
                                              jdec.finish(jst), full):
        assert w == w_j == w_f
        np.testing.assert_allclose(c, c_j, rtol=1e-5)
        np.testing.assert_allclose(c, c_f, rtol=1e-4, atol=1e-2)


def test_streaming_pipeline_matches_offline(graphs):
    """StreamingPipeline == offline forward + one-shot decode
    (tests/test_unilstm.py:246); partial() between chunks leaves the
    result alone."""
    _, g, tg = graphs
    jcfg, jp, tcfg, tp, feats, lengths, lp = uni_setup(graphs, 13)
    cfg = tbeam.BeamSearchConfig(**BCFG)
    ref = offline_decode(tg, lp, lengths, cfg)
    pipe = tstream.StreamingPipeline(tp, tcfg, tg, cfg, device="cpu")
    st = pipe.start(2)
    for t0, t1 in chunks(18, 5):
        cl = np.clip(lengths - t0, 0, t1 - t0)
        st = pipe.step(st, feats[:, t0:t1], cl)
        pipe.partial(st)
        assert len(st["chunks_host"]) == len(st["chunks_dev"])
    for (w, c), (w_r, c_r) in zip(pipe.finish(st), ref):
        assert w == w_r
        np.testing.assert_allclose(c, c_r, rtol=1e-5)


def word_lp(lang, rng):
    """Peaked posteriors of many short words: several words a chunk."""
    seq = ["a", "b", "<blk>"] * 8
    return np.stack([_peaked(rng, lang, seq, t_per=1)] * 2)


def test_summary_overflow_raises_in_finish_and_flags_partial(graphs):
    """An explicit cap below the words a chunk emits: finish() raises
    OverflowError and partial() truncates and sets state["truncated"], in
    both packages."""
    lang, g, tg = graphs
    lp = word_lp(lang, np.random.default_rng(0)).astype(np.float32)
    t = lp.shape[1]
    cfg = tbeam.BeamSearchConfig(**BCFG)
    dec = tbeam.StreamingBeamDecoder(tg, cfg, summary_words=1, device="cpu")
    jdec = jbeam.StreamingBeamDecoder(
        g, jbeam.BeamSearchConfig(pallas_dedup="never", **BCFG),
        summary_words=1)
    dst, jst = dec.start(2), jdec.start(2)
    for t0, t1 in chunks(t, 12):
        dst = dec.accept(dst, lp[:, t0:t1])
        jst = jdec.accept(jst, jnp.asarray(lp[:, t0:t1]))
    assert dec.partial(dst) == jdec.partial(jst)
    assert dst["truncated"] is True and jst["truncated"] is True
    with pytest.raises(OverflowError):
        dec.finish(dst)
    with pytest.raises(OverflowError):
        jdec.finish(jst)
    # the cap sized from the chunk length holds the same chunks
    auto = tbeam.StreamingBeamDecoder(tg, cfg, device="cpu")
    ast = auto.start(2)
    for t0, t1 in chunks(t, 12):
        ast = auto.accept(ast, lp[:, t0:t1])
    full = offline_decode(tg, lp, np.array([t, t]), cfg)
    assert auto.finish(ast) == full


def test_pipeline_partial_drops_the_truncated_flag(graphs):
    """Pinned reference behaviour (eesen_tpu/models/streaming.py:217):
    StreamingPipeline.partial() sets `truncated` on a dict it builds for
    the call and throws away, so the caller's state never carries it, in
    either package; finish() raises all the same."""
    _, g, tg = graphs
    jcfg, jp, tcfg, tp, feats, lengths, lp = uni_setup(graphs, 13)
    # a sharper output layer emits words in most chunks
    tp["out"]["w"] = tp["out"]["w"] * 40.0
    jp["out"]["w"] = jp["out"]["w"] * 40.0
    pipe = tstream.StreamingPipeline(tp, tcfg, tg,
                                     tbeam.BeamSearchConfig(**BCFG),
                                     summary_words=0, device="cpu")
    jpipe = jstream.StreamingPipeline(
        jp, jcfg, g, jbeam.BeamSearchConfig(pallas_dedup="never", **BCFG),
        summary_words=0)
    st, jst = pipe.start(2), jpipe.start(2)
    for t0, t1 in chunks(18, 6):
        cl = np.clip(lengths - t0, 0, t1 - t0)
        st = pipe.step(st, feats[:, t0:t1], cl)
        jst = jpipe.step(jst, feats[:, t0:t1], cl)
    assert pipe.partial(st) == jpipe.partial(jst)
    assert "truncated" not in st and "truncated" not in jst
    with pytest.raises(OverflowError):
        pipe.finish(st)
    with pytest.raises(OverflowError):
        jpipe.finish(jst)
