"""Device milliseconds per window step in the train step's
``part.backward()``: autograd through the model (kernels C, D and E, or
cuDNN's and the GroupNorm backward, where their parameters train): from
the device reaching the phase's entry event to its reaching the exit
event, summed over the step's volumes, idle inside included
(:mod:`benchmark.program_spans`)."""

from benchmark import program_spans


def start(run):
    return program_spans.attach(run)


def read(ctx):
    return program_spans.device_ms(ctx, "backward")
