"""The share of the traced window in which no device record runs: one
less the union of the kernels', copies' and fills' intervals over the
window, from the profiler's timeline."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
