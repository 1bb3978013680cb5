"""The readings that the limits of `correct` are set from, on the GPU at
the cell's own sizes; not part of a benchmark run:

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \\
        --modes program,control[,half_batch] [--out FILE]

For every seed, in one process: the cell's set-up and first steps
(training; no window, no warm-up pass), or four chunks with the longest
first (decode), then each mode's compared numbers against the reference:

- program: what the port produced;
- control: the reference one precision below the configuration's put in
  the program's place (fp8 products for training, bf16 scores for the
  search);
- half_batch (training): the reference with half of every batch left
  out, the mean taken over the rest.

Prints one JSON line a seed (and appends it to --out).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        common.log("needs a CUDA device")
        return 2
    c = common.cell(args.workload)
    device = torch.device("cuda:0")
    modes = args.modes.split(",")
    kind = c["traffic"]["kind"]
    cells = common.module("cells", kind)
    kw = {}
    if kind == "decode_pool":
        from benchmark.graph import build
        kw["graph_dir"] = build.ensure(c["config"], c["config_path"])
    common.log(f"card: {common.power_limit()}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = cells.Cell(c, seed, device, warm=False, **kw)
        if kind == "decode_pool":
            stats = cell.window(0.0, min_chunks=args.chunks, first=[0])
            res = cell.check_modes(stats, modes)
        else:
            res = cell.check_modes(modes)
        line = {"workload": args.workload, "seed": seed,
                "seconds": time.perf_counter() - t0,
                "peak_bytes": int(torch.cuda.max_memory_allocated()),
                **res}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
