"""frame_host_us.decode: the host's wall microseconds a searched batch
frame in the traced chunks (span `decode.frame`, one an iteration of the
search's frame loop: its launches, and any wait on the device inside
it)."""

from benchmark.metrics.spans import traced_sum


def read(ctx):
    ns = traced_sum(ctx, "span_ns:decode.frame")
    n = traced_sum(ctx, "span_n:decode.frame")
    if ns is None or not n:
        return None
    return ns / n / 1e3
