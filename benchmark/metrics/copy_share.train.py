"""copy_share.train: the host's time in `Trainer.run_epoch`'s copy of
the next batch to the device (span `train.input_copy`) over the traced
stretch, in %.  The copy from pageable memory waits for the kernels
queued before it, so the span holds that wait too."""

from benchmark.metrics.spans import share_of_stretch


def read(ctx):
    return share_of_stretch(ctx, "train.input_copy")
