"""Utilities: epoch timing and ``torch.profiler`` tracing."""
