"""Host milliseconds one train step spends enqueuing ``part.backward()``:
autograd through the model (kernels C, D and E, or cuDNN's and the
GroupNorm backward, where their parameters train), with CUDA's queue
empty: of the step calls made after the traced window, each once the
device has finished the one before, the median one
(:mod:`benchmark.program_spans`). The four ``*_enqueue_ms.train`` tile
that call, which ``dispatch_ms.train`` times from outside."""

from benchmark import program_spans


def start(run):
    return program_spans.attach(run)


def read(ctx):
    return program_spans.enqueue_ms(ctx, "backward")
