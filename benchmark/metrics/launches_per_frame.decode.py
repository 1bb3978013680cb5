"""launches_per_frame.decode: the host's kernel launch calls that the
profiler recorded in the traced chunks, per searched batch frame (the
frame loop's length, the chunk's compacted T')."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    labels = {label for label, _ in ctx["traced"]}
    frames = sum(r["searched"] for _, r in ctx["traced"])
    n = sum(trace.segment_of(e["ts"]) in labels for e in trace.launches)
    if not frames or not n:
        return None
    return n / frames
