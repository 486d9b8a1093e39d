"""The GroupNorm launches' least time from shapes (``counts.gn_bound_s``)
times the window's steps, over the device time of the kernels of group
"gn" (``csrc/group_norm.cu``), from the trace. Nothing to read where the
route launches none (the fused route)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"]:
        return None
    busy = tr["by_group"].get("gn", 0.0)
    if busy <= 0 or ctx["gn_bound_s_step"] <= 0:
        return None
    return 100.0 * ctx["gn_bound_s_step"] * ctx["steps"] / busy
