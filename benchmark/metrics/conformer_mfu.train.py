"""conformer_mfu.train: the Conformer's forward and backward operations
over the window's batches (metrics/conformer_costs.step_flops, summed
per batch into the window's `model_flops`) over the window's wall time
and the H100's dense bf16 peak, in %."""

from benchmark.common import H100_BF16_FLOPS


def read(ctx):
    s = ctx["stats"]
    if not s.get("model_flops") or not s.get("window_s"):
        return None
    return 100.0 * s["model_flops"] / s["window_s"] / H100_BF16_FLOPS
