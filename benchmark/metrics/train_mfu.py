"""train_mfu: the model's FLOPs on the window's real frames over the
window's wall time and the H100's dense bf16 peak, in %."""

from benchmark.common import H100_BF16_FLOPS
from benchmark.metrics.costs import model_flops_per_frame


def read(ctx):
    s = ctx["stats"]
    if not s.get("real_frames"):
        return None
    flops = s["real_frames"] * model_flops_per_frame(ctx["cfg"])
    return 100.0 * flops / s["window_s"] / H100_BF16_FLOPS
