"""The stress recipe (examples/stress_recipe.py) with its search observed:

    python3 -m eesen_tpu_torch.tools.stress_timing [--out FILE] [--] \
        [workdir] [stress_recipe arguments]

runs `stress_recipe.main` on the given arguments (its defaults are the
full run: 24,000 / 150 / 300 utterances, 200,000 LM sentences, on the
card) and adds to its results the card's name and power limit
(`nvidia-smi`) and, per search table, the largest live arc count of any
row in any frame: the lanes a merge actually fills, beside the static
width that decides its route (results["graph"]["merges"]).  The results
(stages with seconds, launches and peak memory; TLG counts; WER per
acwt; the parity battery) are printed as one JSON line and written to
FILE when given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def card_label() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or
    "not measured" where there is none."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return res.stdout.strip().splitlines()[0]


def degree_peaks():
    """Wrap the search's two expansions (decoder/beam._expand and, with
    arc budgets, _expand_compact) so that the largest live degree total
    of any row, per table (0 emit, 1 closure), is kept on the device;
    returns (peaks, restore)."""
    import torch
    from eesen_tpu_torch.decoder import beam

    real = beam._expand, beam._expand_compact
    peaks = {}

    def keep(offs, scores, which):
        deg = torch.where(torch.isfinite(scores), offs[..., 2 * which + 1],
                          0).sum(dim=1).max()
        peaks[which] = torch.maximum(peaks.get(which, deg), deg)

    def expand(offs, scores, packed, degree_cap, which):
        keep(offs, scores, which)
        return real[0](offs, scores, packed, degree_cap, which)

    def expand_compact(offs, scores, packed, which, m_budget):
        keep(offs, scores, which)
        return real[1](offs, scores, packed, which, m_budget)

    def restore():
        beam._expand, beam._expand_compact = real

    beam._expand, beam._expand_compact = expand, expand_compact
    return peaks, restore


def run(argv):
    """stress_recipe.main(argv) with the degree peaks and the card added
    to its results."""
    from eesen_tpu_torch.examples import stress_recipe

    peaks, restore = degree_peaks()
    try:
        res = stress_recipe.main(argv)
    finally:
        restore()
    res["card"] = card_label()
    res["live_arcs_peak"] = {name: int(peaks[i]) for i, name in
                             ((0, "emit"), (1, "closure")) if i in peaks}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args, rest = ap.parse_known_args(argv)
    if rest[:1] == ["--"]:
        rest = rest[1:]
    res = run(rest)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
