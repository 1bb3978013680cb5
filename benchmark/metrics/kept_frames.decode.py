"""kept_frames.decode: frames the search was given (the compaction's
kept counts) over the original frames of the window's utterances, in %."""


def read(ctx):
    s = ctx["stats"]
    if not s.get("frames"):
        return None
    return 100.0 * s["kept_frames"] / s["frames"]
