"""rel_attention_roofline.train: the relative-position attention op in
the traced steps, the sum of its least times (conformer_costs.
attention_bounds) over the device time of every kernel launched inside
the host ranges of the two ops `eesen_torch::rel_pos_attention` and
`eesen_torch::rel_pos_attention_bwd` (paired with their launches by
correlation, as `Trace.by_segment` pairs them), in %.

A step counts only where no launch call of the step lacks its record
and the op ranges that start in it equal the program's counters
`rel_attention_fwd` and `rel_attention_bwd` over it.  A tree without the
ops or the counters reads None."""

import bisect

from benchmark.metrics.conformer_costs import attention_bounds

OPS = {"fwd": "eesen_torch::rel_pos_attention",
       "bwd": "eesen_torch::rel_pos_attention_bwd"}
COUNTER = {"fwd": "rel_attention_fwd", "bwd": "rel_attention_bwd"}


def outermost(events):
    """[(start, end)] of the events not inside an earlier one, sorted."""
    out = []
    for s, e in sorted((ev["ts"], ev["ts"] + ev.get("dur", 0.0))
                       for ev in events):
        if out and s < out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def inside(ranges, starts, ts):
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ts <= ranges[i][1]


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    ranges = {k: outermost([e for e in trace.host_ops if e["name"] == op])
              for k, op in OPS.items()}
    if not any(ranges.values()):
        return None
    starts = {k: [s for s, _ in r] for k, r in ranges.items()}
    segs = trace.by_segment()
    bound_s = time_s = 0.0
    for label, batch in ctx["traced"]:
        seg, cnt = segs.get(label), ctx["counts"].get(label)
        if seg is None or cnt is None or seg["orphans"] \
                or any(c not in cnt for c in COUNTER.values()):
            continue
        n = {k: sum(trace.segment_of(s) == label for s, _ in r)
             for k, r in ranges.items()}
        if any(n[k] == 0 or n[k] != cnt[COUNTER[k]] for k in OPS):
            continue
        bounds = attention_bounds(ctx["cfg"], batch["feat_lengths"],
                                  batch["feats"].shape[1])
        bound_s += sum(bounds.values())
        time_s += sum(dur * 1e-6 for ts, _, dur in seg["kernels"]
                      if any(inside(ranges[k], starts[k], ts) for k in OPS))
    if time_s <= 0.0:
        return None
    return 100.0 * bound_s / time_s
