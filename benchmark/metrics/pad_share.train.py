"""pad_share.train: padded frames over all frames of the window's
batches (the batcher's time quantisation and fixed batch rows), in %."""


def read(ctx):
    s = ctx["stats"]
    if not s.get("padded_frames"):
        return None
    return 100.0 * (s["padded_frames"] - s["real_frames"]) / s["padded_frames"]
