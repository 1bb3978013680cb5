"""Run one cell of the benchmark of eesen_tpu_torch once, on this
machine's GPU:

    python3 benchmark/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration
(configs/<config>.json) and a traffic mix (traffic/<traffic>.json), whose
`kind` selects the generator (traffic/<kind>.py) and the cell's code
(cells/<kind>.py).  The run makes its traffic and weights from the
seed, sets up and warms up (all of it `setup_s`, counted from the start
of this script), measures for `--seconds`, reads the per-layer metrics
with `--trace 1` (metrics/<metric>.py on a profiled stretch of the
window), then frees the program's state and compares what the window's
path produced with the plain reference (reference/), against the limits
in limits/<cell>.json.  The last line on stdout is one JSON object:
correct, attempted, failed, metrics, device (and with --trace 1
breakdown), then the compared numbers under `checks`.

Without a CUDA device, or in a tree without the port, it exits non-zero
and prints no result.  It never imports JAX or the JAX package; it exits
non-zero if either is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    c = common.cell(args.workload)
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        common.log(f"needs {chips} CUDA device(s); found "
                   f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import eesen_tpu_torch  # noqa: F401  (fails where the port is absent)
    from eesen_tpu_torch.utils.stages import launch_counts

    common.log(f"card: {common.power_limit()}")
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    result, checks = run_cell(c, args.seed, args.seconds, bool(args.trace),
                              device, launch_counts)
    found = common.forbidden_modules()
    if found:
        common.log(f"loaded after the window: {', '.join(found)}")
        return 3
    common.emit(result, checks)
    return 0


def run_cell(c, seed, seconds, trace, device, counters=None, fault=None,
             **kw):
    """Set-up, window, per-layer metrics (trace) or end-to-end ones, and
    the check: (result without `checks`, the checks)."""
    import torch

    on_card = device.type == "cuda"
    cells = common.module("cells", c["traffic"]["kind"])
    tracer = common.Tracer(trace, counters)
    cell = cells.Cell(c, seed, device, tracer, fault=fault, **kw)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    common.log(f"setup_s {setup_s:.3f}")

    stats = cell.window(seconds)
    device_info = common.device_block(c["workload"]["chips"], device)
    common.log(f"window: {stats['window_s']:.3f} s, "
               + ", ".join(f"{k} {v}" for k, v in stats.items()
                           if isinstance(v, (int, float))))
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
              "device": device_info}
    if trace:
        result["metrics"] = per_layer(c, cell, stats, tracer)
        tr = tracer.trace
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
        cross_check(tr, tracer.counts)
    else:
        result["metrics"] = cell.end_to_end(stats)
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    attempted = stats["attempted"]
    with common.stage("check"):
        checks = common.judge(cell.check(stats), c["limits"])
    ok = all(ch["ok"] for ch in checks)
    result.update(correct=ok, attempted=attempted,
                  failed=0 if ok else attempted)
    return result, checks


def per_layer(c, cell, stats, tracer):
    """The cell's per-layer metrics from their readers; a reader that
    finds nothing is left out."""
    traced = [(f"step{i}", b) for i, b in
              enumerate(stats.get("traced", []), start=2)]
    if "done" in stats:
        traced = [(f"chunk{i}", r) for i, r in enumerate(stats["done"])
                  if r.get("traced")]
    ctx = {"stats": stats, "cfg": c["config"], "spec": c["traffic"],
           "trace": tracer.trace, "traced": traced,
           "counts": common.segment_counts(tracer.counts),
           "graph": getattr(cell, "graph", None)}
    out = {}
    for m in c["per_layer"]:
        v = common.reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def cross_check(trace, counts) -> None:
    """Each kernel's profiler records in the traced stretch beside the
    port's own launch counter over it."""
    if len(counts) < 2:
        return
    first, last = counts[0][1], counts[-1][1]
    names = {"lstm_fwd": "lstm_rec_kernel", "lstm_bwd": "lstm_bwd_rec_kernel",
             "ctc_alpha": "ctc_alpha_kernel", "ctc_beta": "ctc_beta_kernel",
             "dedup_prune": "dedup_prune_kernel"}
    for counter, kernel in names.items():
        common.log(f"records {kernel}: {trace.count(kernel)} profiler, "
                   f"{last[counter] - first[counter]} launched")
    orphans = sum(s["orphans"] for s in trace.by_segment().values())
    common.log(f"launch calls without a kernel record: {orphans} of "
               f"{len(trace.launches)}")


if __name__ == "__main__":
    sys.exit(main())
