"""graphed_frames.decode: the traced chunks' searched frames that the
search ran by replaying a captured CUDA graph (the program's counter
`search_graph_frames`) over every frame it searched there (the count of
span `decode.frame`, which counts a replayed block's frames), in %."""

from benchmark.metrics.spans import traced_sum


def read(ctx):
    graphed = traced_sum(ctx, "search_graph_frames")
    frames = traced_sum(ctx, "span_n:decode.frame")
    if graphed is None or not frames:
        return None
    return 100.0 * graphed / frames
