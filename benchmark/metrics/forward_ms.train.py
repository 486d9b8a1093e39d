"""Device milliseconds per window step in the train step's the model's
forward (``UNet3D``: kernels A and B, the resize and the head on the
fused route; cuDNN and the GroupNorm kernels on the other): from the
device reaching the phase's entry event to its reaching the exit event,
summed over the step's volumes, idle inside included
(:mod:`benchmark.program_spans`)."""

from benchmark import program_spans


def start(run):
    return program_spans.attach(run)


def read(ctx):
    return program_spans.device_ms(ctx, "forward")
