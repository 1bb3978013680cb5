"""The share of the traced stretch in which no kernel or copy ran on
the device, in %."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
