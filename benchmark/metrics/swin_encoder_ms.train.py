"""Device milliseconds per window step in the Swin UNETR encoder's forward
(``swinViT``: the patch embedding, the four stages of window attention,
LayerNorm and MLPs, the patch merges and the five hidden-state norms):
the model's span ``swin_encoder``, from the device reaching its entry
event to its reaching the exit event, idle inside included. ``start``
hangs the run's recorder (:func:`benchmark.program_spans.attach`) on the
model as well as on the step; a model without a ``spans`` attribute
records nothing, and the metric is then left out."""

from benchmark import program_spans

SPAN = "swin_encoder"


def start(run):
    spans = program_spans.attach(run)
    if spans is not None and hasattr(run.model, "spans"):
        run.model.spans = spans
    return spans


def read(ctx):
    got = program_spans._per_step(ctx, "device")
    if got is None:
        return None
    window, _, ms = got
    total = sum(ms[s].get(SPAN, 0.0) for s in window)
    return total / len(window) if total > 0 else None
