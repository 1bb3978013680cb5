"""The port's forced alignment (eesen_tpu_torch/ops/align.py) and profiler
(eesen_tpu_torch/utils/profile.py) on the CPU against the JAX package's
(eesen_tpu/ops/align.py, eesen_tpu/utils/profile.py)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eesen_tpu.ops import align as jalign
from eesen_tpu.utils import profile as jprof
from eesen_tpu_torch.ops import align as talign
from eesen_tpu_torch.utils import profile as tprof

from tests.test_align_mbr import peaked_logprobs

DELTA_ATOL = 1e-5


def batch(seed, b=4, t=23, v=7, l_max=5):
    """Random log-softmax rows with mixed frame and label lengths (a
    repeated label, a label-free row), seeded."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, v)).astype(np.float32) * 2.0
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    lens = np.asarray([t, t - 5, 9, 4][:b], np.int32)
    lab_lens = np.asarray([l_max, 3, 2, 0][:b], np.int32)
    labels = rng.integers(1, v, (b, l_max)).astype(np.int32)
    labels[0, 1] = labels[0, 0]              # a repeat: no skip there
    labels[np.arange(l_max)[None, :] >= lab_lens[:, None]] = 0
    return lp.astype(np.float32), lens, labels, lab_lens


@pytest.mark.parametrize("seed", range(3))
def test_ctc_viterbi_matches_jax(seed):
    lp, lens, labels, lab_lens = batch(seed)
    delta, psi = talign.ctc_viterbi(torch.from_numpy(lp), lens, labels,
                                    lab_lens)
    jdelta, jpsi = jalign.ctc_viterbi(
        jnp.asarray(lp), jnp.asarray(lens), jnp.asarray(labels),
        jnp.asarray(lab_lens))
    assert psi.dtype == torch.int8 and delta.dtype == torch.float32
    np.testing.assert_array_equal(psi.numpy(), np.asarray(jpsi))
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta),
                               rtol=0, atol=DELTA_ATOL)


@pytest.mark.parametrize("seed", range(3))
def test_ctc_align_batched_mixed_lengths(seed):
    lp, lens, labels, lab_lens = batch(seed)
    got = talign.ctc_align(torch.from_numpy(lp), torch.from_numpy(lens),
                           torch.from_numpy(labels), lab_lens)
    want = jalign.ctc_align(jnp.asarray(lp), jnp.asarray(lens),
                            jnp.asarray(labels), jnp.asarray(lab_lens))
    assert [len(a) for a in got] == list(lens)
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        assert talign.align_to_segments(a) == jalign.align_to_segments(b)


def test_ctc_align_recovers_segments():
    """tests/test_align_mbr.py's peaked case through both packages."""
    frame_seq = [0, 2, 2, 2, 0, 3, 3, 0, 2, 2]
    ll = peaked_logprobs(frame_seq, v=5, t_per=1)[None]
    got = talign.ctc_align(ll, [10], [[2, 3, 2]], [3])
    want = jalign.ctc_align(jnp.asarray(ll), jnp.asarray([10]),
                            jnp.asarray([[2, 3, 2]], jnp.int32),
                            jnp.asarray([3]))
    np.testing.assert_array_equal(got[0], frame_seq)
    np.testing.assert_array_equal(got[0], want[0])
    segs = talign.align_to_segments(got[0])
    assert segs == jalign.align_to_segments(want[0]) == [
        (2, 1, 4), (3, 5, 7), (2, 8, 10)]


def test_align_to_segments_edge_cases():
    for ali in ([], [0, 0], [4], [1, 1, 0, 1, 2, 2, 0], [3, 0, 3, 3]):
        a = np.asarray(ali, np.int32)
        assert talign.align_to_segments(a) == jalign.align_to_segments(a)
        assert (talign.align_to_segments(a, blank_id=3)
                == jalign.align_to_segments(a, blank_id=3))


def test_profiler_text_matches_jax():
    """Equal totals give the JAX package's text, line for line."""
    t, j = tprof.Profiler(), jprof.Profiler()
    for p in (t, j):
        p.accumulate("op_b", 0.25)
        p.accumulate("op_a", 0.5)
        p.accumulate("op_a", 0.125)
        p.accumulate("op_c", 0.0625)
    assert t.print_profile() == j.print_profile()
    assert t.counts == j.counts == {"op_b": 1, "op_a": 2, "op_c": 1}
    with t.track("op_d"):
        pass
    assert t.counts["op_d"] == 1 and t.totals["op_d"] >= 0.0
    t.reset()
    assert not t.totals and not t.counts
    assert isinstance(tprof.profiler, tprof.Profiler)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.ones(4).add_(1.0)
    path = os.path.join(str(tmp_path), "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("add_" in e.get("name", "") for e in events)


def test_memory_stats_cpu_is_none():
    assert tprof.memory_stats("cpu") is None
