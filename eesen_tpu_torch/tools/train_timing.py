"""Time the training step of one checkout of the port.

    python3 eesen_tpu_torch/tools/train_timing.py [--tree DIR] [--label NAME]

Builds the kernel library of the checkout at DIR (default: the one this
file is in) and times that checkout's `training.trainer.make_train_step`
at chip_smoke.py's training shapes: the WSJ-phn 4 x 320 model and the
LibriSpeech char 4 x 640 model (no dropout), B=128, T=768, L=100 and
200, SGD momentum 0.9, from the same seeded parameters and batches.
After two warm-up steps, REPS runs of chip_smoke.TRAIN_STEPS chained
steps, each run timed on the host clock to torch.cuda.synchronize():
seconds a step of every run and their median.  Inputs, settings and
timers are this file's chip_smoke.py.  Prints the card's name and power
limit, then one JSON line.  Two checkouts timed in one call on one card
(in the order parent, change, change, parent) compare.  Needs a card
and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
REPS = 5


def _smoke():
    """chip_smoke.py of this checkout, for its inputs and timers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="root of the checkout whose trainer is timed")
    ap.add_argument("--label", default="this", help="name in the line")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch
    from eesen_tpu_torch.ops import build
    from eesen_tpu_torch.training.trainer import (
        create_train_state, make_train_step,
    )

    if not pathlib.Path(build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"eesen_tpu_torch imported from {build.__file__}")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smoke = _smoke()
    dev = torch.device("cuda")
    build.load()
    print(json.dumps({"label": args.label, "card": smoke.card_label()}),
          flush=True)

    def seconds_a_step(cfg, batch):
        st, tx = create_train_state(torch.Generator().manual_seed(smoke.SEED),
                                    cfg, smoke.train_opt(), device=dev)
        step = make_train_step(cfg, tx)
        for _ in range(2):
            st, _ = step(st, batch, None, smoke.LEARN_RATE)
        runs = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(smoke.TRAIN_STEPS):
                st, _ = step(st, batch, None, smoke.LEARN_RATE)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / smoke.TRAIN_STEPS)
        return {"runs": runs, "median": statistics.median(runs)}

    wsj_cfg, _, _, wsj_batch = smoke.train_setup(dev)
    out = {"label": args.label,
           "wsj_s_per_step": seconds_a_step(wsj_cfg, wsj_batch),
           "libri_s_per_step": seconds_a_step(
               smoke.libri_config(dropout=False),
               smoke.libri_batch(dev, smoke.TRAIN_B))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
