"""mfu.train: the model FLOPs of the steps completed in the window
(bench/harness/flops.py:ssm_train_flops, recomputation not counted)
over the window times the chip's bf16 peak."""
from bench.harness import flops


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return 100.0 * ctx["flops_step"] * ctx["steps"] / (
        ctx["window_s"] * flops.PEAK_BF16_FLOPS)
