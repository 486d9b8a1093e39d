"""Seconds from the process's start to the end of the warm-up: import,
CUDA initialisation, kernels, subjects, model and weights, first steps."""


def read(ctx):
    return ctx["setup_s"]
