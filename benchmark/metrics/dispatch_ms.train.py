"""Host time of one step call with CUDA's queue empty: the median of the
step calls that a traced run makes after its window, each once the device
has finished the one before (the benchmark's own host span around
``step(state, x, labels)``). Inside the window the host waits in a launch
once the queue is full, so there a step call lasts as long as the card's
step; here it is what the host itself spends enqueuing one."""

import statistics


def read(ctx):
    spans = ctx.get("dispatch_s")
    if not spans:
        return None
    return 1e3 * statistics.median(spans)
