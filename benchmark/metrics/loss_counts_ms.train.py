"""Device milliseconds per window step in the train step's ``prep`` (the
optimizer's zeroing, the valid count), ``loss`` (labels, cross-entropy,
the division) and ``counts`` (the loss's sum and the confusion counts'
``index_add_``): from the device reaching the phase's entry event to its
reaching the exit event, summed over the step's volumes, idle inside
included (:mod:`benchmark.program_spans`)."""

from benchmark import program_spans


def start(run):
    return program_spans.attach(run)


def read(ctx):
    return program_spans.device_ms(ctx, "loss_counts")
