"""BENCHMARK.json names only files that exist, and every name the
harness looks up by has its file."""

import json
import os
import re

from benchmark import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_resolves():
    b = common.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for cfg in b["configs"]:
        path = os.path.join(common.ROOT, cfg["file"])
        d = json.load(open(path))
        assert d["name"] == cfg["name"]
        assert d["reduced"] == cfg["reduced"]
    for w in b["workloads"]:
        c = common.cell(w["name"])
        kind = c["traffic"]["kind"]
        for sub in ("traffic", "cells"):
            assert os.path.exists(os.path.join(common.BENCH, sub,
                                               f"{kind}.py"))
        assert c["end_to_end"] and c["per_layer"]
        assert "setup_s" in [m["name"] for m in c["end_to_end"]]
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(common.BENCH, "metrics",
                                           f"{m['name']}.py"))
        assert hasattr(common.reader(m["name"]), "read")
