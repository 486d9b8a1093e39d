"""The whole step's share of the chip's bf16 peak: the step's matrix
operations from shapes (``counts.step_flops``: convs, transposed convs and
the head, forward, dx and dW as the trainable set needs them) times the
window's steps, over the window's time at 989 TFLOP/s."""

from benchmark.counts import PEAK_BF16_FLOPS


def read(ctx):
    if not ctx["steps"] or ctx["window_s"] <= 0:
        return None
    achieved = ctx["flops_step"] * ctx["steps"] / ctx["window_s"]
    return 100.0 * achieved / PEAK_BF16_FLOPS
