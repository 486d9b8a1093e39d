"""The convolution work's least time from shapes (``counts.conv_bound_s``)
times the window's steps, over the device time of the kernels that
``kernel_classes.json`` puts in group "conv" (A, C, D and their fold on
the fused route; cuDNN on the non-fused one), from the trace."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"]:
        return None
    busy = tr["by_group"].get("conv", 0.0)
    if busy <= 0 or ctx["conv_bound_s_step"] <= 0:
        return None
    return 100.0 * ctx["conv_bound_s_step"] * ctx["steps"] / busy
