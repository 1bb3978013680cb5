"""The reader of metrics/graphed_frames.decode.py on made-up traced
chunks: the program's counter of replayed frames over the frames its
frame span counted, in the traced segments only; None on the counters
of a tree without the counter or the span."""

import pytest

from benchmark import common


def ctx(graphed=(448, 576), frames=(448, 640), counter=True, span=True):
    def seg(g, n):
        c = {"dedup_prune": 1 + 2 * n}
        if counter:
            c["search_graph_frames"] = g
        if span:
            c["span_n:decode.frame"] = n
        return c

    return {"traced": [("chunk1", {"searched": frames[0]}),
                       ("chunk2", {"searched": frames[1]})],
            "counts": {"chunk1": seg(graphed[0], frames[0]),
                       "chunk2": seg(graphed[1], frames[1]),
                       "chunk3": seg(0, 512)}}


def read(c):
    return common.reader("graphed_frames.decode").read(c)


def test_share_of_the_traced_frames():
    assert read(ctx()) == pytest.approx(100.0 * 1024 / 1088)


def test_every_frame_replayed_reads_100():
    assert read(ctx(graphed=(448, 640))) == pytest.approx(100.0)


def test_an_eager_search_reads_0():
    assert read(ctx(graphed=(0, 0))) == 0.0


def test_only_the_traced_segments_count():
    c = ctx()
    c["traced"] = c["traced"][1:]
    assert read(c) == pytest.approx(100.0 * 576 / 640)


@pytest.mark.parametrize("kw", [dict(counter=False), dict(span=False)])
def test_a_tree_without_the_counter_reads_none(kw):
    assert read(ctx(**kw)) is None
    assert read({**ctx(), "counts": {}}) is None
    assert read({**ctx(), "traced": []}) is None
