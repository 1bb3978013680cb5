"""traceback_share.decode: the host's time in `decoder/beam.traceback`
(span `decode.traceback`: the search's outputs copied to the host and
walked in Python) over the traced stretch, in %."""

from benchmark.metrics.spans import share_of_stretch


def read(ctx):
    return share_of_stretch(ctx, "decode.traceback")
