"""The readers of the program's spans (metrics/copy_share.train.py,
frame_host_us.decode.py, traceback_share.decode.py) on a made-up traced
stretch: counters over two segments, the stretch's length, the traced
labels; and on the counters of a tree without the spans.  The program's
counters take the harness's segment differences from their first span
on."""

import types

import pytest

from benchmark import common

WINDOW_S = 0.5


def train_ctx(spans=True):
    def seg(copy_ns):
        c = {"lstm_fwd": 8, "lstm_bwd": 8}
        if spans:
            c.update({"span_ns:train.input_copy": copy_ns,
                      "span_n:train.input_copy": 1})
        return c

    return {"trace": types.SimpleNamespace(window_s=WINDOW_S),
            "traced": [("step2", {}), ("step3", {})],
            "counts": {"step2": seg(40_000_000), "step3": seg(35_000_000)}}


def decode_ctx(spans=True):
    def seg(frame_ns, frames, tb_ns):
        c = {"dedup_prune": 2 * frames}
        if spans:
            c.update({"span_ns:decode.frame": frame_ns,
                      "span_n:decode.frame": frames,
                      "span_ns:decode.traceback": tb_ns,
                      "span_n:decode.traceback": 1})
        return c

    return {"trace": types.SimpleNamespace(window_s=WINDOW_S),
            "traced": [("chunk1", {"searched": 128}),
                       ("chunk2", {"searched": 192})],
            "counts": {"chunk1": seg(300_000_000, 128, 10_000_000),
                       "chunk2": seg(500_000_000, 192, 15_000_000)}}


def test_copy_share_train():
    got = common.reader("copy_share.train").read(train_ctx())
    assert got == pytest.approx(100.0 * 0.075 / WINDOW_S)     # 15%


def test_frame_host_us_decode():
    got = common.reader("frame_host_us.decode").read(decode_ctx())
    assert got == pytest.approx(800_000_000 / 320 / 1e3)      # 2,500 us


def test_traceback_share_decode():
    got = common.reader("traceback_share.decode").read(decode_ctx())
    assert got == pytest.approx(100.0 * 0.025 / WINDOW_S)     # 5%


@pytest.mark.parametrize("name,ctx", [
    ("copy_share.train", train_ctx),
    ("frame_host_us.decode", decode_ctx),
    ("traceback_share.decode", decode_ctx),
])
def test_a_tree_without_the_spans_reads_none(name, ctx):
    reader = common.reader(name)
    assert reader.read(ctx(spans=False)) is None
    assert reader.read({**ctx(), "counts": {}}) is None
    assert reader.read({**ctx(), "traced": []}) is None


def test_only_the_traced_segments_count():
    ctx = decode_ctx()
    ctx["traced"] = ctx["traced"][1:]
    got = common.reader("frame_host_us.decode").read(ctx)
    assert got == pytest.approx(500_000_000 / 192 / 1e3)
    got = common.reader("traceback_share.decode").read(ctx)
    assert got == pytest.approx(100.0 * 0.015 / WINDOW_S)


def test_segment_counts_over_the_programs_counters():
    """Every span key is in the program's snapshot before any span, so
    `segment_counts` takes the difference around a first span; a counter
    key that first appeared mid-stretch would raise KeyError there."""
    from eesen_tpu_torch.utils.profile import profiler
    from eesen_tpu_torch.utils.stages import launch_counts
    a = launch_counts()
    with profiler.track("decode.traceback"):
        pass
    seg = common.segment_counts([("chunk1", a), ("end", launch_counts())])
    moved = {k: v for k, v in seg["chunk1"].items() if v}
    assert set(moved) == {"span_ns:decode.traceback",
                          "span_n:decode.traceback"}
    assert moved["span_n:decode.traceback"] == 1
    assert all(isinstance(v, int) for v in seg["chunk1"].values())
