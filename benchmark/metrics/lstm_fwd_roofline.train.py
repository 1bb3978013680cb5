"""lstm_fwd_roofline.train: kernel 1 (projection + recurrence) in the
traced steps, sum of bounds over sum of recorded device time, in %."""

from benchmark.metrics.lstm_roofline import roofline


def read(ctx):
    return roofline(ctx, "fwd")
