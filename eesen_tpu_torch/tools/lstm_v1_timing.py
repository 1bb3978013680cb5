"""Time kernels 4 and 5 (the v1 LSTM route) of one checkout of the port,
and fingerprint kernels 1 and 3 at the recipes' shapes.

    python3 eesen_tpu_torch/tools/lstm_v1_timing.py [--tree DIR] [--label NAME]

Builds the kernel library of the checkout at DIR (default: the one this
file is in) and, on the inputs and with the timers of this file's own
chip_smoke.py:
- times the checkout's `lstm_scan_fwd` and `lstm_scan_bwd` wrappers at
  B=128, T=768 and H in (640, 1152): the median ms of one launch between
  CUDA events, with a SHA-256 of the outputs' bits;
- runs kernel 1 (`lstm_direction` with residuals, bf16, state_bf16) and
  kernel 3 (`lstm_direction_bwd` on those residuals) at the training shapes
  of the WSJ and LibriSpeech recipes (B=128, T=768; D=640, H=320 and
  D=1280, H=640) and kernel 1 at WSJ serving (B=8, T=512, D=640, H=320):
  ms and a SHA-256 of every output's bits.
Prints the card's name and power limit, then one JSON line per kernel and
shape.  Two checkouts run in one call on one card (a parent and a change,
in the order parent, change, change, parent) compare in time and, for
kernels 1 and 3, in bits.  Needs a card and nvcc.
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


def _sha(tensors) -> str:
    """SHA-256 (16 hex digits) of the tensors' bits, in order."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--label", default="this", help="name in each line")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import numpy as np
    import torch
    from eesen_tpu_torch.ops import build, lstm_cuda, lstm_v1_cuda

    if not pathlib.Path(build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"eesen_tpu_torch imported from {build.__file__}")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smoke = _smoke()
    dev = torch.device("cuda")
    build.load()

    def emit(**row):
        print(json.dumps({"label": args.label, **row}), flush=True)

    emit(card=smoke.card_label())
    b, t = smoke.TRAIN_B, smoke.TRAIN_T
    for h, seed in ((smoke.LIBRI_H, smoke.SEED + 21),
                    (smoke.V1_H, smoke.SEED + 25)):
        inp = smoke.scan_inputs(dev, seed, h)
        res = lstm_v1_cuda.lstm_scan_fwd(**inp)
        gm = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
            res[0].shape).astype(np.float32)).to(dev)
        bwd = dict(mask=inp["mask"], gates=res[3], c_raw=res[2], c=res[1],
                   gm=gm, w_m=inp["w_m"], ph=inp["ph"])
        for name, fn, a in (("lstm_scan_fwd", lstm_v1_cuda.lstm_scan_fwd, inp),
                            ("lstm_scan_bwd", lstm_v1_cuda.lstm_scan_bwd, bwd)):
            ms = smoke._cuda_ms(lambda: fn(**a), 3)
            out = fn(**a)
            torch.cuda.synchronize()
            emit(kernel=name, shape=f"B={b} T={t} H={h}", ms=ms,
                 us_per_step=ms * 1e3 / t,
                 sha256=_sha(out if isinstance(out, tuple) else [out]))
        del inp, res, bwd, gm
        torch.cuda.empty_cache()
    for d, h in ((640, 320), (2 * smoke.LIBRI_H, smoke.LIBRI_H)):
        fwd, bwd = smoke.train_lstm_inputs(d, h, dev, smoke.SEED + d + 1, True)

        def k1():
            return lstm_cuda.lstm_direction(**fwd, state_bf16=True,
                                            with_residuals=True)

        for name, fn in (("lstm_fwd", k1),
                         ("lstm_bwd",
                          lambda: lstm_cuda.lstm_direction_bwd(**bwd))):
            ms = smoke._cuda_ms(fn, 3)
            out = fn()
            torch.cuda.synchronize()
            emit(kernel=name, shape=f"B={b} T={t} D={d} H={h}", ms=ms,
                 sha256=_sha(out))
        del fwd, bwd
    inp = smoke.lstm_inputs(640, 320, dev, smoke.SEED + 640)
    out = lstm_cuda.lstm_direction(**inp, state_bf16=True)
    torch.cuda.synchronize()
    emit(kernel="lstm_fwd", shape=f"B={smoke.B} T={smoke.T_MAX} D=640 H=320",
         ms=smoke._cuda_ms(lambda: lstm_cuda.lstm_direction(
             **inp, state_bf16=True), 5), sha256=_sha([out]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
