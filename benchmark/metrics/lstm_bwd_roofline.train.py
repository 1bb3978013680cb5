"""lstm_bwd_roofline.train: kernel 3 (reverse recurrence + its three
products) in the traced steps, sum of bounds over sum of recorded device
time, in %."""

from benchmark.metrics.lstm_roofline import roofline


def read(ctx):
    return roofline(ctx, "bwd")
