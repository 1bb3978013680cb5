"""A whole run at a toy size on the CPU, the harness's look for a card
skipped: the result line has the contract's keys with the compared
numbers last; a sound run is correct; a run with its timed path broken
underneath is not."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import common, run
from benchmark.tests import toy

CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}
CPU = torch.device("cpu")


def _line(result, checks):
    buf = io.StringIO()
    with redirect_stdout(buf):
        common.emit(result, checks)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["wsj_phn.train", "librispeech_char.train"])
def test_train_run_line_and_correct(name):
    c = toy.train_cell(name)
    result, checks = run.run_cell(c, 2**31 + 99, 0.5, False, CPU)
    line = _line(result, checks)
    assert set(line) == CONTRACT | {"checks"}
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(c["limits"]["limits"])
    assert set(line["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}


def test_decode_run_line_and_correct(tmp_path):
    c, gdir = toy.decode_cell(str(tmp_path))
    result, checks = run.run_cell(c, 2**31 + 98, 0.5, False, CPU,
                                  graph_dir=gdir)
    line = _line(result, checks)
    assert set(line) == CONTRACT | {"checks"}
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"decode_audio_s_per_s", "setup_s"}
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_a_broken_training_step_is_not_correct(fault):
    c = toy.train_cell()
    result, checks = run.run_cell(c, 17, 0.2, False, CPU, fault=fault)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] > 0


def test_an_altered_word_is_not_correct(tmp_path):
    c, gdir = toy.decode_cell(str(tmp_path))
    # the altered word sits in the first row of every chunk served, so
    # the sample holds one wherever it lands
    c["traffic"]["check_utterances"] = 12
    result, checks = run.run_cell(c, 17, 0.2, False, CPU, fault="token",
                                  graph_dir=gdir)
    assert result["correct"] is False
    assert {ch["name"]: ch["ok"] for ch in checks}["word_cost_gap"] is False


def test_a_missing_card_gives_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "wsj_phn.train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", ["wsj_phn.train", "librispeech_char.train",
                                  "wsj_phn.decode_lm",
                                  "wsj_phn.decode_lm_k5000"])
def test_the_control_is_not_correct(name, tmp_path):
    """The reference one precision below the configuration's, put in the
    program's place, fails the cell's own limits (the chip readings at
    full size: benchmark/readings.py)."""
    from benchmark.cells import decode_pool, train_pool

    if name.endswith(".train"):
        c = toy.train_cell(name)
        cell = train_pool.Cell(c, 23, CPU, warm=False)
        numbers = cell.check_modes(["control"])["control"]
    else:
        c, gdir = toy.decode_cell(str(tmp_path), name)
        cell = decode_pool.Cell(c, 23, CPU, graph_dir=gdir, warm=False)
        stats = cell.window(0.0, min_chunks=2, first=[0])
        numbers = cell.check_modes(stats, ["control"])["control"]
    checks = common.judge(numbers, c["limits"])
    assert not all(ch["ok"] for ch in checks), checks
