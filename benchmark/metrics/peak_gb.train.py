"""Peak device memory over the window (``max_memory_allocated`` after
``reset_peak_memory_stats`` at its start), in GB."""


def read(ctx):
    if not ctx["peak_window_bytes"]:
        return None
    return ctx["peak_window_bytes"] / 1e9
