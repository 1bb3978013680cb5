"""Time the serving decode of one checkout of the port.

    python3 eesen_tpu_torch/tools/decode_timing.py [--tree DIR] [--label NAME]

Builds the kernel library of the checkout at DIR (default: the one this
file is in), serves chip_smoke.py's WSJ batch (B=8, T=512, the 4 x 320
model, random weights) through that checkout's `recipes.run.run_search`
on the 261,570-state TLG, then decodes its posteriors again REPS times,
and decodes chip_smoke.py's synthetic converged posteriors in full and,
where the checkout has decoder/frame_skip.py, with blank-skip (0.98):
wall ms per original frame of each decode (host clock, synchronized,
profiler off), and the profiler's idle share of one more serving decode.
Inputs, settings and timers are this file's chip_smoke.py.  Prints the
card's name and power limit, then one JSON line.  Two checkouts timed in
one call on one card (in the order parent, change, change, parent)
compare.  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
REPS = 3


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
                    help="root of the checkout whose decoder is timed")
    ap.add_argument("--label", default="this", help="name in the line")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import numpy as np
    import torch
    from eesen_tpu_torch.decoder.beam import (
        BeamSearchConfig, DeviceGraph, make_beam_decoder,
    )
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
    g, lang, lex = smoke.build_graph(2000, 20000)[:3]
    state = {}
    main = smoke.phase_main(dev, {"packed": (g, lang, lex)}, state)
    dec = make_beam_decoder(g, BeamSearchConfig(**smoke.DECODE))
    dg = DeviceGraph.put(g, device=dev)

    def per_frame(fn):
        ms, _ = smoke._wall_ms(fn, REPS)
        return ms / smoke.T_MAX

    out = {"label": args.label, "serve_wall_s": main["wall_s"],
           "serve_decode_ms_per_frame": per_frame(
               lambda: dec(state["lp"], state["lens"], dg)),
           "serve_decode_idle_share": smoke._profile(
               lambda: dec(state["lp"], state["lens"], dg))["idle_share"]}
    lens = np.asarray(smoke.LENGTHS, np.int32)
    ll = torch.from_numpy(smoke.search_posteriors(lang, lex)).to(dev)
    out["synth_full_ms_per_frame"] = per_frame(lambda: dec(ll, lens, dg))
    out["synth_skip_ms_per_frame"] = None
    if (tree / "eesen_tpu_torch/decoder/frame_skip.py").exists():
        from eesen_tpu_torch.decoder.frame_skip import compact_blank_frames

        def skip():
            cf = compact_blank_frames(ll, lens, smoke.SKIP_THRESHOLD)
            return dec(cf.loglikes, cf.lengths, dg)

        out["synth_skip_ms_per_frame"] = per_frame(skip)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
