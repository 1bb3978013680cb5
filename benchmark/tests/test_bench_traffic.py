"""The traffic is the same for a seed, its sizes are the same for every
seed, and its lengths have the stated means."""

import numpy as np
import pytest

from benchmark import common
from benchmark.traffic import decode_pool, train_pool
from benchmark.tests import toy

TRAIN = ["wsj_phn.train", "librispeech_char.train"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_sizes_match_the_corpus(name):
    c = common.cell(name)
    spec, cfg = c["traffic"], c["config"]
    frames, labels = train_pool.sizes(spec, cfg["frame_s"])
    assert len(frames) == spec["utterances"]
    mean_s = frames.mean() * cfg["frame_s"]
    assert abs(mean_s - spec["mean_s"]) / spec["mean_s"] < 0.05
    assert frames.min() * cfg["frame_s"] >= spec["min_s"] - cfg["frame_s"]
    assert frames.max() * cfg["frame_s"] <= spec["max_s"] + cfg["frame_s"]
    rate = labels.sum() / (frames.sum() * cfg["frame_s"])
    assert abs(rate - spec["labels_per_s"]) / spec["labels_per_s"] < 0.05
    assert (2 * labels <= np.maximum(frames, 2)).all()


@pytest.mark.parametrize("name", TRAIN)
def test_train_pool_is_a_function_of_the_seed(name):
    c = toy.train_cell(name)
    a = train_pool.make(c["traffic"], c["config"], 2**31 + 7, "cpu")
    b = train_pool.make(c["traffic"], c["config"], 2**31 + 7, "cpu")
    d = train_pool.make(c["traffic"], c["config"], 11, "cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x.feats, y.feats)
        assert np.array_equal(x.labels, y.labels)
    assert [len(u.feats) for u in a] == [len(u.feats) for u in d]
    assert [len(u.labels) for u in a] == [len(u.labels) for u in d]
    assert not np.array_equal(a[0].feats, d[0].feats)
    ba = train_pool.batches(c["traffic"], a)
    bd = train_pool.batches(c["traffic"], d)
    assert [x["feats"].shape for x in ba] == [x["feats"].shape for x in bd]


def test_pass_orders_cover_every_batch_each_pass():
    it = train_pool.pass_orders(7, 5, 3)
    first, second = [next(it) for _ in range(7)], [next(it) for _ in range(7)]
    assert sorted(first) == sorted(second) == list(range(7))
    again = train_pool.pass_orders(7, 5, 3)
    assert [next(again) for _ in range(7)] == first


@pytest.mark.parametrize("name", ["wsj_phn.decode_lm",
                                  "wsj_phn.decode_lm_k5000"])
def test_decode_sizes_match_the_eval_sets(name):
    c = common.cell(name)
    n = decode_pool.sizes(c["traffic"], c["config"]["frame_s"])
    assert len(n) == c["traffic"]["utterances"]
    mean_s = n.mean() * c["config"]["frame_s"]
    assert abs(mean_s - c["traffic"]["mean_s"]) / c["traffic"]["mean_s"] < 0.05


def test_decode_pool_is_a_function_of_the_seed(tmp_path):
    c, gdir = toy.decode_cell(str(tmp_path))
    prons = np.load(f"{gdir}/prons.npy")
    a = decode_pool.make(c["traffic"], c["config"], prons, 2**31 + 3, "cpu")
    b = decode_pool.make(c["traffic"], c["config"], prons, 2**31 + 3, "cpu")
    d = decode_pool.make(c["traffic"], c["config"], prons, 4, "cpu")
    for x, y, z in zip(a, b, d):
        assert np.array_equal(x.lp, y.lp)
        assert np.array_equal(x.lengths, z.lengths)
        assert x.lp.shape == z.lp.shape
    assert not np.array_equal(a[0].lp, d[0].lp)
    # converged posteriors: rows are log-distributions, mostly blank
    x = a[0].lp[0, :a[0].lengths[0]]
    assert np.allclose(np.exp(x).sum(-1), 1.0, atol=1e-4)
    assert (x.argmax(-1) == 0).mean() > 0.5


def test_every_stretch_of_the_order_mixes_the_sizes():
    from benchmark.traffic.order import stratified
    it = stratified(32, 9, 2, 8)
    for _ in range(3):                       # three passes
        one_pass = [next(it) for _ in range(32)]
        assert sorted(one_pass) == list(range(32))
        for r in range(4):
            run = one_pass[8 * r: 8 * r + 8]
            assert sorted(i // 4 for i in run) == list(range(8))
