"""Blank-skip and greedy decoding in the port
(eesen_tpu_torch/decoder/{frame_skip,greedy}.py and the blank-skip branch
of recipes/run.run_search) against the JAX package on the CPU, on the
same log-posteriors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.decoder import beam as jbeam
from eesen_tpu.decoder import frame_skip as jskip
from eesen_tpu.decoder import greedy as jgreedy
from eesen_tpu.decoder.arpa import arpa_to_fst
from eesen_tpu.decoder.ctc_graph import build_lg, build_tlg, compile_lang
from eesen_tpu.decoder.graph_compile import compile_graph
from eesen_tpu.models import model as jmodel
from eesen_tpu_torch.decoder import beam as tbeam
from eesen_tpu_torch.decoder import frame_skip as tskip
from eesen_tpu_torch.decoder import graph_compile as t_gc
from eesen_tpu_torch.decoder import greedy as tgreedy
from eesen_tpu_torch.models import model as tmodel
from eesen_tpu_torch.recipes import run as trun

from tests.test_ctc_graph import ARPA, LEXICON, UNITS
from tests.test_frame_skip import _peaked

SEQS = [
    ["a", "<blk>", "<blk>", "b", "<blk>", "b", "<blk>", "a"],
    ["a", "a", "<blk>", "<blk>", "<blk>", "b", "c", "<blk>"],
]


@pytest.fixture(scope="module")
def tlg():
    lang = compile_lang(LEXICON, UNITS, dict_type="phn")
    fst = build_tlg(lang.t_fst, build_lg(
        lang.l_fst, arpa_to_fst(ARPA, lang.words)))
    g = compile_graph(fst, max_degree=8, build_closure=True)
    tg = t_gc.CompiledGraph(**{f.name: getattr(g, f.name)
                               for f in dataclasses.fields(t_gc.CompiledGraph)})
    return lang, g, tg


def _normalize(ll):
    return ll - np.log(np.exp(ll).sum(-1, keepdims=True))


def case_runs():
    """tests/test_frame_skip.py:37: one run in row 0, none in row 1, a
    whole row of blank in row 2."""
    rng = np.random.default_rng(0)
    ll = rng.standard_normal((3, 20, 5)).astype(np.float32)
    ll[0, 3:10, 0] += 12.0
    ll[2, :, 0] += 12.0
    return _normalize(ll), np.array([20, 15, 12], np.int32), 0.98


def case_high_threshold():
    """tests/test_frame_skip.py:81: random frames, threshold 0.999."""
    rng = np.random.default_rng(1)
    ll = _normalize(rng.standard_normal((2, 10, 4)).astype(np.float32))
    return ll, np.array([10, 10], np.int32), 0.999


def case_peaked():
    """tests/test_frame_skip.py:89: peaked CTC posteriors of two unit
    sequences, padded to one length."""
    lang = compile_lang(LEXICON, UNITS, dict_type="phn")
    rng = np.random.default_rng(7)
    lls = [_peaked(rng, lang, s, t_per=3) for s in SEQS]
    t_max = max(x.shape[0] for x in lls)
    ll = np.stack([np.pad(x, ((0, t_max - x.shape[0]), (0, 0)))
                   for x in lls]).astype(np.float32)
    return ll, np.array([x.shape[0] for x in lls], np.int32), 0.98


def case_short_runs():
    """Runs of 1-4 blank frames between spikes, so min_run=3 keeps some
    runs verbatim and merges others; ragged lengths with a zero row."""
    rng = np.random.default_rng(3)
    b, t, v = 4, 48, 6
    ll = rng.standard_normal((b, t, v)).astype(np.float32)
    for i in range(b):
        pos = 0
        while pos < t:
            ll[i, pos, int(rng.integers(1, v))] += 9.0
            run = int(rng.integers(1, 5))
            ll[i, pos + 1:pos + 1 + run, 0] += 12.0
            pos += 1 + run
    return _normalize(ll), np.array([48, 41, 17, 0], np.int32), 0.98


CASES = {"runs": case_runs, "high_threshold": case_high_threshold,
         "peaked": case_peaked, "short_runs": case_short_runs}


def compare(ll, lens, thresh, bucket, min_run):
    want = jskip.compact_blank_frames(ll, lens, thresh, bucket=bucket,
                                      min_run=min_run)
    got = tskip.compact_blank_frames(torch.from_numpy(ll), lens, thresh,
                                     bucket=bucket, min_run=min_run)
    w_len = np.asarray(want.lengths)
    np.testing.assert_array_equal(got.lengths.numpy(), w_len)
    assert tuple(got.loglikes.shape) == tuple(want.loglikes.shape)
    assert tuple(got.time_map.shape) == tuple(want.time_map.shape)
    w_ll, w_tm = np.asarray(want.loglikes), np.asarray(want.time_map)
    for i, n in enumerate(w_len):
        np.testing.assert_array_equal(got.time_map[i, :n].numpy(),
                                      w_tm[i, :n])
        np.testing.assert_allclose(got.loglikes[i, :n].numpy(), w_ll[i, :n],
                                   rtol=0, atol=1e-5)
    return got


@pytest.mark.parametrize("bucket", [4, 8, 64])
@pytest.mark.parametrize("min_run", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compaction_matches_jax(case, min_run, bucket):
    """Lengths and time_map on the valid slots exact; loglikes within
    1e-5 (f32, the blank run sums taken as cumsum differences in both)."""
    ll, lens, thresh = CASES[case]()
    compare(ll, lens, thresh, bucket, min_run)


def test_compaction_merges_and_keeps_as_the_reference_says():
    """The hand-counted case of tests/test_frame_skip.py:37 in the port:
    kept counts 14, 15, 1 and the 16-slot bucket."""
    ll, lens, thresh = case_runs()
    got = compare(ll, lens, thresh, 4, 1)
    assert got.lengths.tolist() == [14, 15, 1]
    assert got.loglikes.shape[1] == 16
    assert got.time_map[2, 0] == 11


@pytest.mark.parametrize("thresh", [0.0, 1.0, -0.5, 1.5])
def test_threshold_validation(thresh):
    ll = np.zeros((1, 4, 3), np.float32)
    with pytest.raises(ValueError):
        tskip.compact_blank_frames(ll, np.array([4]), thresh)
    with pytest.raises(ValueError):
        jskip.compact_blank_frames(ll, np.array([4]), thresh)


def test_skip_search_matches_jax_and_full_search(tlg):
    """The port's compacted search gives the JAX package's compacted
    search's words and costs (rtol 1e-5) and its own full search's words
    (tests/test_frame_skip.py:97)."""
    lang, g, tg = tlg
    ll, lens, _ = case_peaked()
    bcfg = dict(beam=1e9, max_active=128, acoustic_scale=0.9)
    jdec = jbeam.make_beam_decoder(
        g, jbeam.BeamSearchConfig(pallas_dedup="never", **bcfg))
    jcf = jskip.compact_blank_frames(ll, lens, 0.98, bucket=8)
    jres = jbeam.traceback(jdec(jcf.loglikes, jcf.lengths,
                                jbeam.DeviceGraph.put(g)),
                           np.asarray(jcf.lengths), g.final_weight)

    tdec = tbeam.make_beam_decoder(tg, tbeam.BeamSearchConfig(**bcfg))
    dg = tbeam.DeviceGraph.put(tg, device="cpu")
    cf = tskip.compact_blank_frames(ll, lens, 0.98, bucket=8)
    assert int(cf.lengths.max()) < int(lens.max())       # merged some
    skip = tbeam.traceback(tdec(cf.loglikes, cf.lengths, dg),
                           cf.lengths, tg.final_weight)
    full = tbeam.traceback(tdec(ll, lens, dg), lens, tg.final_weight)
    for (w_s, c_s), (w_j, c_j), (w_f, c_f) in zip(skip, jres, full):
        assert w_s == w_j == w_f
        np.testing.assert_allclose(c_s, c_j, rtol=1e-5)
        np.testing.assert_allclose(c_s, c_f, rtol=1e-4, atol=1e-2)


def test_blank_skip_config_is_ported(tlg):
    """BeamSearchConfig(blank_skip=0.98) builds a decoder; the bucket
    defaults to the JAX package's."""
    cfg = tbeam.BeamSearchConfig(blank_skip=0.98)
    assert cfg.blank_skip_bucket == jbeam.BeamSearchConfig().blank_skip_bucket
    tbeam.make_beam_decoder(tlg[2], cfg)


@pytest.fixture(scope="module")
def served():
    """A small BiLSTM whose prior-divided posteriors have blank runs."""
    jcfg = jmodel.AcousticModelConfig(
        input_dim=8, cell_dim=8, num_layers=1, num_targets=1 + len(UNITS),
        compute_dtype=jnp.float32,
    )
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_model(jax.random.PRNGKey(0), jcfg))
    # peaked posteriors with a blank bias: some frames are blank-dominated
    # after the priors are subtracted, none before
    params["out"]["w"] = params["out"]["w"] * 40.0
    params["out"]["b"] = params["out"]["b"] + np.eye(
        1 + len(UNITS), dtype=np.float32)[0] * 2.0
    tcfg = tmodel.AcousticModelConfig(
        input_dim=8, cell_dim=8, num_layers=1, num_targets=1 + len(UNITS),
        compute_dtype=torch.float32,
    )
    rng = np.random.default_rng(2)
    lens = (30, 22, 13)
    feats = {f"u{i}": rng.standard_normal((n, 8)).astype(np.float32)
             for i, n in enumerate(lens)}
    log_priors = np.log(np.array([0.7] + [0.3 / len(UNITS)] * len(UNITS)))
    return dict(params=tmodel.params_from_jax(params, device="cpu"),
                tcfg=tcfg, feats=feats, log_priors=log_priors)


def test_run_search_compacts_the_prior_divided_posteriors(served, tlg):
    """run_search with blank_skip yields the compaction of posteriors()
    with the priors subtracted (not of the raw log-softmax), and searches
    it; decode's words equal the search of that compaction."""
    s = served
    tg = tlg[2]
    cfg = tbeam.BeamSearchConfig(beam=16.0, max_active=64, blank_skip=0.9,
                                 blank_skip_bucket=4)
    (chunk, lp, lens, out), = list(trun.run_search(
        s["params"], s["tcfg"], tg, s["feats"], s["log_priors"], cfg,
        batch_size=3, time_bucket=1, device="cpu"))
    arr, full_lens = trun._pad_chunk(s["feats"], chunk, 1, 3)
    prior_lp = trun.posteriors(s["params"], s["tcfg"], arr, full_lens,
                               s["log_priors"], device="cpu")
    raw_lp = trun.posteriors(s["params"], s["tcfg"], arr, full_lens,
                             None, device="cpu")
    want = tskip.compact_blank_frames(prior_lp, full_lens, 0.9, bucket=4)
    raw = tskip.compact_blank_frames(raw_lp, full_lens, 0.9, bucket=4)
    np.testing.assert_array_equal(lens, want.lengths.numpy())
    assert (lens < full_lens).any()                       # merged some
    assert not np.array_equal(lens, raw.lengths.numpy())  # priors matter
    torch.testing.assert_close(lp, want.loglikes, rtol=0, atol=0)
    dec = tbeam.make_beam_decoder(tg, cfg)
    ref = tbeam.traceback(
        dec(want.loglikes, want.lengths,
            tbeam.DeviceGraph.put(tg, device="cpu")),
        want.lengths, tg.final_weight)
    assert tbeam.traceback(out, lens, tg.final_weight) == ref
    hyps = trun.decode(s["params"], s["tcfg"], tg, s["feats"],
                       s["log_priors"], cfg, batch_size=3, time_bucket=1,
                       device="cpu")
    assert [hyps[k] for k in chunk] == ref


@pytest.mark.parametrize("blank", [0, 2])
def test_greedy_matches_jax(blank):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 17, 6)).astype(np.float32)
    logits[:, ::3, blank] += 3.0       # repeats and blanks to collapse
    logits[1, 4:9] = logits[1, 4]      # a repeated frame run
    lens = np.array([17, 9, 0], np.int32)
    want = jgreedy.greedy_decode_logits(jnp.asarray(logits), lens, blank)
    assert tgreedy.greedy_decode_logits(
        torch.from_numpy(logits), torch.from_numpy(lens), blank) == want
    assert tgreedy.greedy_decode_logits(logits, lens, blank) == want
    for i in range(3):
        assert tgreedy.greedy_decode(logits[i], blank) == \
            jgreedy.greedy_decode(logits[i], blank)
