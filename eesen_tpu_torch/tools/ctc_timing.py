"""Time kernels 6 and 7 (CTC alpha and beta) of one checkout of the port.

    python3 eesen_tpu_torch/tools/ctc_timing.py [--tree DIR] [--label NAME]

Builds the kernel library of the checkout at DIR (default: the one this
file is in) and times its `ctc_alpha` and `ctc_beta` entries at
chip_smoke.py's CTC_CASES shapes (B=128), on the inputs chip_smoke.py's
timing phase gives them and with its timers: the median ms of one launch
between CUDA events, and the ms a launch over 10 launches back to back.
Prints the card's name and power limit, then one JSON line per kernel and
shape with a SHA-256 of the output's bits.  Two checkouts timed in one
call on one card (a parent and a change, in the order parent, change,
change, parent) compare in time and in bits.  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


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
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--label", default="this", help="name in each line")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch
    from eesen_tpu_torch.ops import build

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
    for case in smoke.CTC_CASES:
        inp, _ = smoke.ctc_train_inputs(dev, smoke.SEED + 3, case)
        lens = inp["logit_lengths"].to(torch.int32)
        buf = torch.empty_like(inp["lp_e"])
        b, t, s = inp["lp_e"].shape
        for which in ("alpha", "beta"):
            def launch():
                smoke._ctc_kernel(which, inp, lens, buf)

            ms = smoke._cuda_ms(launch, 20)
            b2b = smoke._cuda_ms_back_to_back(launch, 5)
            launch()
            torch.cuda.synchronize()
            bits = hashlib.sha256(buf.cpu().numpy().tobytes()).hexdigest()
            print(json.dumps({
                "label": args.label, "kernel": f"ctc_{which}",
                "shape": f"B={b} T={t} S={s}", "ms": ms,
                "us_per_step": ms * 1e3 / t, "ms_back_to_back": b2b,
                "us_per_step_back_to_back": b2b * 1e3 / t,
                "sha256": bits[:16]}), flush=True)
        del inp, lens, buf
    return 0


if __name__ == "__main__":
    sys.exit(main())
