"""The Conformer-CTC cell (conformer_ctc_large.train): its costs against
a hand count, its traffic's truncation and rows, both readers on a
made-up trace, and the whole cell on the CPU at a toy size, correct
under the cell's limits and not correct with its step broken."""

import copy
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from benchmark import common, run
from benchmark.metrics import conformer_costs as cc
from benchmark.traffic import conformer_pool as traffic

NAME = "conformer_ctc_large.train"
CPU = torch.device("cpu")
SMALL = dict(input_dim=16, d_model=32, n_layers=2, n_heads=4,
             conv_kernel_size=5, subsampling_conv_channels=16, num_targets=7)


def toy_cell(f32=True):
    c = copy.deepcopy(common.cell(NAME))
    c["config"].update(SMALL)
    if f32:
        c["config"].update(compute_dtype="float32")
    c["traffic"].update(utterances=24, mean_s=0.6, min_s=0.3, max_s=0.9,
                        trace_steps=1,
                        batch={"num_sequence": 6, "frame_limit": 400,
                               "time_quant": 16, "fixed_batch": False})
    return c


def test_costs_against_a_hand_count():
    cfg = dict(SMALL, ff_expansion_factor=4, compute_dtype="bfloat16")
    lengths = [40, 17]              # T1 = 20, 9; T' = 10, 5
    d, c, v = 32, 16, 7
    # per subsampled frame: 2 layers x (2 FFN x 2 x 2 d 4d + 4 x 2 d^2
    # + 2 d 2d + 2 d^2) + depthwise 2 x 2 d 5 + conv2 2 9 c c 4
    # + linear 2 (4c) d + output 2 d v; conv1 2 9 c 8 a T1 frame
    per_frame = (2 * (2 * 2 * 2 * d * 4 * d + 8 * d * d + 4 * d * d
                      + 2 * d * d)
                 + 2 * 2 * d * 5 + 2 * 9 * c * c * 4 + 2 * 4 * c * d
                 + 2 * d * v)
    att = 6 * d * 2 * (10 * 10 + 5 * 5)
    pos = 2 * d * d * 19 * 2
    conv1 = 2 * 9 * c * 8 * (20 + 9)
    want = 3 * (15 * per_frame + att + pos + conv1) - conv1
    assert cc.step_flops(cfg, lengths) == pytest.approx(want, rel=1e-12)
    # the op's bound on a padded [2, 48 -> 12] batch
    b = cc.attention_bounds(cfg, lengths, 48)
    fwd_bytes = 4 * 2 * 12 * d * 2 + 23 * d * 2 + 2 * d * 4 + 2 * 4 * 12 * 4
    assert b["fwd"] == pytest.approx(2 * max(att / 2 / 989e12,
                                             fwd_bytes / 3.35e12))
    assert b["bwd"] > b["fwd"]


def test_the_published_model_has_121_5_million_parameters():
    cfg = common.cell(NAME)["config"]
    assert cc.num_params(cfg) == 121_501_313
    from benchmark.cells import conformer_pool
    from eesen_tpu_torch.models.conformer import param_shapes
    from eesen_tpu_torch.models.model import model_num_params
    shapes = param_shapes(conformer_pool.model_config(cfg))
    meta = {k: v for k, v in shapes.items() if k != "buffers"}

    def count(node):
        if isinstance(node, dict):
            return sum(count(x) for x in node.values())
        if isinstance(node, list):
            return sum(count(x) for x in node)
        return int(np.prod(node[1]))

    assert count(meta) == cc.num_params(cfg)
    small = dict(SMALL, ff_expansion_factor=4)
    toy = conformer_pool.make_params(dict(cfg, **small,
                                          compute_dtype="float32"), 3, CPU)
    assert model_num_params(toy) == cc.num_params(dict(cfg, **small))


def test_the_cell_draws_its_own_weights(monkeypatch):
    """The cell's weights come from the configuration's widths, not from
    the port's initialisation: the port's tree, every leaf its own, within
    its bound, u and v drawn, BatchNorm at its start."""
    from benchmark.cells import conformer_pool
    from eesen_tpu_torch.models import conformer as tconf

    cfg = dict(common.cell(NAME)["config"], **SMALL)
    port = tconf.init_conformer(torch.Generator().manual_seed(0),
                                conformer_pool.model_config(cfg), "cpu")
    monkeypatch.setattr(tconf, "init_conformer", None)
    p = conformer_pool.make_params(cfg, 2**32 + 9, CPU)

    def paths(t, pre=""):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in paths(t[k], f"{pre}/{k}")]
        if isinstance(t, list):
            return [x for i, v in enumerate(t) for x in paths(v, f"{pre}/{i}")]
        return [(pre, tuple(t.shape), t.dtype)]

    assert paths(p) == paths(port)
    d, dk = SMALL["d_model"], SMALL["d_model"] // SMALL["n_heads"]
    att = p["layers"][0]["att"]
    for leaf, bound in ((att["q"]["w"], d ** -0.5), (att["q"]["b"], d ** -0.5),
                        (att["pos_u"], dk ** -0.5), (att["pos_v"], dk ** -0.5),
                        (p["layers"][0]["conv"]["dw"]["w"],
                         SMALL["conv_kernel_size"] ** -0.5),
                        (p["subsample"]["conv2"]["w"],
                         (9 * SMALL["subsampling_conv_channels"]) ** -0.5)):
        assert 0.8 * bound < float(leaf.abs().max()) <= bound
    assert not torch.equal(p["layers"][0]["ff1"]["in"]["w"],
                           p["layers"][1]["ff1"]["in"]["w"])
    assert not torch.equal(att["pos_u"], att["pos_v"])
    assert torch.equal(p["layers"][1]["conv"]["bn"]["gamma"], torch.ones(d))
    assert int(p["buffers"][1]["count"]) == 0
    assert float(p["buffers"][0]["var"].min()) == 1.0
    q = conformer_pool.make_params(cfg, 2**32 + 10, CPU)
    assert not torch.equal(p["out"]["w"], q["out"]["w"])


def test_the_cell_refuses_other_adam_constants():
    from benchmark.cells import conformer_pool

    c = toy_cell()
    c["config"]["optimizer"] = dict(c["config"]["optimizer"], b2=0.999)
    with pytest.raises(ValueError, match="AdamW"):
        conformer_pool.Cell(c, 5, CPU, warm=False)


def test_traffic_is_truncated_and_has_no_empty_rows():
    c = common.cell(NAME)
    spec, cfg = c["traffic"], c["config"]
    dur = traffic.durations(spec)
    assert len(dur) == spec["utterances"]
    assert dur.min() >= 1.0 and dur.max() <= 16.7
    # truncated, not clipped: nothing piles up on the bounds
    assert (dur > 16.6).mean() < 0.01 and (dur < 1.1).mean() < 0.01
    assert 10.0 < dur.mean() < 12.3
    frames, labels = traffic.sizes(spec, cfg["frame_s"])
    assert (labels <= np.maximum(traffic.subsampled(frames) // 2, 1)).all()
    assert (frames == traffic.sizes(spec, cfg["frame_s"])[0]).all()
    small = dict(cfg, input_dim=2)
    spec = dict(spec, utterances=300)
    utts = traffic.make(spec, small, 5, CPU)
    batches = traffic.batches(spec, utts)
    assert sum(len(b["keys"]) for b in batches) == 300
    for b in batches:
        assert (b["feat_lengths"] > 0).all()
        assert b["feats"].shape[0] == len(b["keys"]) <= 128
        assert b["feats"].shape[1] % 128 == 0
        assert b["feat_lengths"].max() * len(b["keys"]) <= 120000


def _trace(ops):
    """The events of a made-up trace of two steps: `ops` lists (step,
    name, ts, dur) host ranges; each has one launch 1 us in and a kernel
    of 10 us, and one kernel is launched outside every range."""
    ev, corr = [], 0
    marks = {"step2": 0.0, "step3": 1000.0, "end": 2000.0}
    for name, ts in [("start", -1.0)] + list(marks.items()):
        ev.append({"ph": "X", "name": common.MARK + name, "ts": ts, "dur": 0,
                   "cat": "user_annotation"})
    for step, name, ts, dur in ops + [("step2", "aten::mm", 500.0, 20.0)]:
        ev.append({"ph": "X", "cat": "cpu_op", "name": name, "ts": ts,
                   "dur": dur})
        corr += 1
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": ts + 1.0, "dur": 1.0,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": "k", "ts": ts + 2.0,
                   "dur": 10.0, "args": {"correlation": corr}})
    return ev


def _ctx(tmp_path, counts):
    fwd, bwd = "eesen_torch::rel_pos_attention", \
        "eesen_torch::rel_pos_attention_bwd"
    ops = [("step2", fwd, 100.0, 50.0), ("step2", bwd, 300.0, 50.0),
           ("step3", fwd, 1100.0, 50.0), ("step3", bwd, 1300.0, 50.0)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _trace(ops)}))
    cfg = dict(SMALL, ff_expansion_factor=4, compute_dtype="bfloat16",
               n_layers=1)
    batch = {"feats": np.zeros((2, 48, 16)), "feat_lengths": np.array([40,
                                                                       17])}
    return {"trace": common.Trace(str(path)), "cfg": cfg,
            "traced": [("step2", batch), ("step3", batch)],
            "counts": counts,
            "stats": {"model_flops": 989e12 * 0.5, "window_s": 2.0}}


def test_readers_on_a_made_up_trace(tmp_path):
    one = {"rel_attention_fwd": 1, "rel_attention_bwd": 1}
    ctx = _ctx(tmp_path, {"step2": one, "step3": one})
    b = cc.attention_bounds(ctx["cfg"], [40, 17], 48)
    got = common.reader("rel_attention_roofline.train").read(ctx)
    # two steps, each two op ranges with a 10 us kernel; aten::mm's not
    assert got == pytest.approx(100.0 * 2 * (b["fwd"] + b["bwd"]) / 40e-6)
    assert common.reader("conformer_mfu.train").read(ctx) == \
        pytest.approx(25.0)
    # a step whose ranges disagree with the counters is left out
    ctx = _ctx(tmp_path, {"step2": one, "step3": {"rel_attention_fwd": 2,
                                                   "rel_attention_bwd": 1}})
    got = common.reader("rel_attention_roofline.train").read(ctx)
    assert got == pytest.approx(100.0 * (b["fwd"] + b["bwd"]) / 20e-6)
    # a tree without the counters reads nothing and raises nothing
    ctx = _ctx(tmp_path, {"step2": {"lstm_fwd": 8}, "step3": {}})
    assert common.reader("rel_attention_roofline.train").read(ctx) is None
    assert common.reader("conformer_mfu.train").read(
        {"stats": {"real_frames": 10, "window_s": 1.0}}) is None


def _line(result, checks):
    buf = io.StringIO()
    with redirect_stdout(buf):
        common.emit(result, checks)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_toy_cell_runs_and_is_correct():
    c = toy_cell()
    result, checks = run.run_cell(c, 2**31 + 77, 0.5, False, CPU)
    line = _line(result, checks)
    assert set(line["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def test_toy_cell_traced_reads_both_metrics():
    from eesen_tpu_torch.utils.stages import launch_counts

    c = toy_cell()
    tracer = common.Tracer(True, launch_counts)
    from benchmark.cells import conformer_pool
    cell = conformer_pool.Cell(c, 11, CPU, tracer)
    real = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a: None      # the tracer's, on the CPU
    try:
        stats = cell.window(0.2)
    finally:
        torch.cuda.synchronize = real
    assert stats["model_flops"] > 0 and stats["traced"]
    ctx = {"stats": stats, "cfg": c["config"], "trace": tracer.trace,
           "traced": [(f"step{i}", b) for i, b in
                      enumerate(stats["traced"], start=2)],
           "counts": common.segment_counts(tracer.counts)}
    assert common.reader("conformer_mfu.train").read(ctx) > 0
    seg = ctx["counts"]["step2"]
    assert seg["rel_attention_fwd"] == seg["rel_attention_bwd"] == 2
    # on the CPU the ops launch no kernel: the ranges are found, the
    # device time is nought, and the reader says nothing
    names = {e["name"] for e in tracer.trace.host_ops}
    assert "eesen_torch::rel_pos_attention" in names
    assert "eesen_torch::rel_pos_attention_bwd" in names
    assert common.reader("rel_attention_roofline.train").read(ctx) is None


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_a_broken_step_is_not_correct(fault):
    result, checks = run.run_cell(toy_cell(), 17, 0.2, False, CPU,
                                  fault=fault)
    assert result["correct"] is False


def test_the_control_is_not_correct():
    from benchmark.cells import conformer_pool

    c = toy_cell()
    cell = conformer_pool.Cell(c, 23, CPU, warm=False)
    numbers = cell.check_modes(["control"])["control"]
    assert not all(ch["ok"] for ch in common.judge(numbers, c["limits"]))


def test_the_configs_adamw_is_the_ports():
    """The port's AdamW keeps NeMo's betas and epsilon as constants; the
    reference reads them from the configuration."""
    from eesen_tpu_torch.training import optim
    o = common.cell(NAME)["config"]["optimizer"]
    assert (o["b1"], o["b2"], o["eps"]) == (
        optim.ADAM_B1, optim.ADAM_B2, optim.ADAM_EPS)
