"""What every cell of the benchmark shares: the files it reads, the
device, the trace of the traced stretch, the per-layer readers and the
result line.

Layout (everything found by the names in BENCHMARK.json):

- configs/<config>.json: a configuration (sizes, precision, optimizer,
  decode graph);
- traffic/<traffic>.json: a traffic mix; its `kind` names the generator
  traffic/<kind>.py and the cell's set-up, window and check in
  cells/<kind>.py;
- metrics/<metric>.py: a per-layer reader, `read(ctx) -> float | None`;
- limits/<cell>.json: the limits of the numbers that decide `correct`.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
TRACE_DIR = os.path.join(BENCH, "_trace")
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "eesen_tpu")
H100_BF16_FLOPS = 989e12      # dense bf16, H100 SXM data sheet
H100_HBM_BYTES_PER_S = 3.35e12


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str) -> Dict:
    """The workload entry, its configuration and its traffic."""
    bench = benchmark()
    w = {c["name"]: c for c in bench["workloads"]}[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg_path = os.path.join(ROOT, cfg_entry["file"])
    return {
        "workload": w,
        "config": load_json(cfg_path),
        "config_path": cfg_path,
        "traffic": load_json(os.path.join(BENCH, "traffic",
                                          f"{w['traffic']}.json")),
        "limits": load_json(os.path.join(BENCH, "limits", f"{name}.json")),
        "end_to_end": [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"]
                      if name in m.get("workloads", [name])],
    }


def module(kind_dir: str, name: str):
    return importlib.import_module(f"benchmark.{kind_dir}.{name}")


def reader(metric: str):
    """metrics/<metric>.py (the name may hold dots) as a module."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except Exception as e:      # the reading is informative only
        return f"nvidia-smi failed: {e}"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -------------------------------------------------------------- trace

LAUNCH_NAMES = ("LaunchKernel", "LaunchCooperativeKernel")
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "bench.mark:"


def mark(label: str) -> None:
    """A zero-length host event in the trace: the boundaries of steps
    and chunks, and of the traced stretch."""
    import torch
    with torch.profiler.record_function(MARK + label):
        pass


class Tracer:
    """torch.profiler over a bounded stretch of whole steps or chunks.
    `start()` / `stop()` synchronize and mark the stretch's ends; `stop()`
    reads the exported trace into `trace` (a `Trace`) and deletes the
    file.  `mark()` marks a step's or chunk's start and takes the port's
    launch counters there."""

    def __init__(self, enabled: bool, counters=None):
        self.enabled = enabled
        self.counters = counters      # the program's launch counters
        self.prof = None
        self.trace = None
        self.counts = []              # (label, counters) at each mark

    def mark(self, label: str) -> None:
        mark(label)
        if self.counters is not None:
            self.counts.append((label, dict(self.counters())))

    def warm(self) -> None:
        """One empty profile, so that the profiler's own start-up falls
        into set-up and not into the stretch."""
        if self.enabled:
            self._profile().__enter__().__exit__(None, None, None)

    def _profile(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        return torch.profiler.profile(activities=acts)

    def start(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.prof = self._profile()
        self.prof.__enter__()
        self.counts = []
        mark("start")

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.mark("end")
        self.prof.__exit__(None, None, None)
        os.makedirs(TRACE_DIR, exist_ok=True)
        path = os.path.join(TRACE_DIR, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        self.trace = Trace(path)
        os.remove(path)


class Trace:
    """The traced stretch: kernels and copies on the device, launch calls
    on the host, and the benchmark's marks, on one clock (microseconds)."""

    def __init__(self, path: str):
        ev = load_json(path)["traceEvents"]
        ev = [e for e in ev if e.get("ph") == "X"]
        marks = sorted((e["ts"], e["name"][len(MARK):]) for e in ev
                       if e.get("name", "").startswith(MARK))
        self.t0 = [ts for ts, n in marks if n == "start"][0]
        self.t1 = [ts for ts, n in marks if n == "end"][-1]
        self.marks = [(ts, n) for ts, n in marks if n != "start"]
        self.gpu = [e for e in ev if e.get("cat") in GPU_CATS]
        self.kernels = [e for e in self.gpu if e["cat"] == "kernel"]
        self.host_ops = [e for e in ev if e.get("cat") == "cpu_op"]
        self.launches = [e for e in ev
                         if e.get("cat") in ("cuda_runtime", "cuda_driver")
                         and any(s in e.get("name", "")
                                 for s in LAUNCH_NAMES)]
        by_corr = {}
        for e in self.launches:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                by_corr[c] = e
        self._launch_of = by_corr
        self.kernel_corr = {e.get("args", {}).get("correlation")
                            for e in self.kernels}

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self) -> float:
        """Seconds of the stretch in which a kernel or copy ran."""
        iv = sorted((max(e["ts"], self.t0),
                     min(e["ts"] + e.get("dur", 0), self.t1))
                    for e in self.gpu)
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in iv:
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy * 1e-6

    def count(self, name: str) -> int:
        """Kernel records whose name holds `name`."""
        return sum(name in e["name"] for e in self.kernels)

    def segment_of(self, ts: float) -> Optional[str]:
        """The label of the last mark at or before ts (a step or chunk)."""
        label = None
        for mts, n in self.marks:
            if mts <= ts:
                label = n
            else:
                break
        return label

    def by_segment(self) -> Dict[str, Dict]:
        """For each step or chunk of the stretch: its kernels (each with
        the host time of its launch), and its launch calls that have no
        kernel record (records the profiler dropped)."""
        seg: Dict[str, Dict] = {}
        for e in self.kernels:
            lau = self._launch_of.get(e.get("args", {}).get("correlation"))
            host_ts = lau["ts"] if lau is not None else e["ts"]
            s = seg.setdefault(self.segment_of(host_ts),
                               {"kernels": [], "orphans": 0})
            s["kernels"].append((host_ts, e["name"], e.get("dur", 0.0)))
        for c, lau in self._launch_of.items():
            if c not in self.kernel_corr:
                s = seg.setdefault(self.segment_of(lau["ts"]),
                                   {"kernels": [], "orphans": 0})
                s["orphans"] += 1
        for s in seg.values():
            s["kernels"].sort()
        return seg

    def device_ops(self, n: int = 10):
        tot: Dict[str, float] = {}
        for e in self.gpu:
            tot[e["name"]] = tot.get(e["name"], 0.0) + e.get("dur", 0.0)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:200], v * 1e-6] for k, v in top]

    def idle_gaps(self, n: int = 10):
        """The longest idle stretches of the device, each named by the
        innermost host operation running at its middle."""
        iv = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in self.gpu)
        gaps, cur = [], self.t0
        for s, e in iv:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            ops = [o for o in self.host_ops
                   if o["ts"] <= mid <= o["ts"] + o.get("dur", 0.0)]
            name = (min(ops, key=lambda o: o.get("dur", 0.0))["name"]
                    if ops else "host: no recorded operation")
            out.append([f"{name[:160]} ({self.segment_of(s)})",
                        (e - s) * 1e-6])
        return out


# ------------------------------------------------------------- result

def segment_counts(counts) -> Dict[str, Dict[str, int]]:
    """The program's launches in each marked segment: the counters'
    change from its mark to the next."""
    out = {}
    for (label, a), (_, b) in zip(counts, counts[1:]):
        out[label] = {k: b[k] - a[k] for k in b}
    return out


def device_block(count: int, device) -> Dict:
    """The contract's `device`; a CPU run (the harness's own tests) says
    so and reads no peak."""
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def emit(result: Dict, checks: List[Dict]) -> None:
    """The result line, last on stdout; the compared numbers beside their
    limits, last on stderr and last in the line."""
    for c in checks:
        log(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}")
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    sys.stdout.flush()
    print(json.dumps(result), flush=True)


def judge(numbers: Dict[str, float], limits: Dict) -> List[Dict]:
    """Each number beside its limit: correct where value <= limit."""
    out = []
    for name, lim in limits["limits"].items():
        v = numbers.get(name)
        ok = v is not None and v == v and v <= lim
        out.append({"name": name, "value": v, "limit": lim, "ok": ok})
    return out


@contextlib.contextmanager
def stage(name: str):
    t = time.perf_counter()
    yield
    log(f"stage {name}: {time.perf_counter() - t:.3f} s")
