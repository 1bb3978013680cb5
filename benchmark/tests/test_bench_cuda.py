"""One 10-second cell on the card (skips where there is none)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import common


@pytest.mark.cuda
def test_a_ten_second_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(common.BENCH, "run.py"), "--workload",
         "wsj_phn.train", "--seed", "424242", "--seconds", "10",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=common.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
