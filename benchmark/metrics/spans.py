"""What the readers of the program's spans share.  `ctx["counts"]`
holds, for each marked step or chunk of the traced stretch, the change of
the program's counters (eesen_tpu_torch/utils/stages.launch_counts) over
it; a span's total nanoseconds and count are the keys "span_ns:<name>"
and "span_n:<name>".  Counters without the key (a tree without the span)
read None."""


def traced_sum(ctx, key):
    """The counter `key` summed over the traced steps' or chunks'
    segments, or None where a segment lacks it."""
    counts = ctx.get("counts") or {}
    segs = [counts.get(label) for label, _ in ctx.get("traced", [])]
    if not segs or any(s is None or key not in s for s in segs):
        return None
    return sum(s[key] for s in segs)


def share_of_stretch(ctx, span):
    """The span's wall time in the traced steps or chunks over the traced
    stretch (the window `device_idle.*` divides by), in %."""
    ns = traced_sum(ctx, "span_ns:" + span)
    trace = ctx.get("trace")
    if ns is None or trace is None or trace.window_s <= 0:
        return None
    return 100.0 * ns * 1e-9 / trace.window_s
