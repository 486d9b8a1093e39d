"""Parameter freezing by torch-style name prefixes.

Counterpart of ``unetsulc_tpu/train/freeze.py``: a parameter is trainable
iff its ``state_dict`` name (``decoders.2.double_conv.conv1.weight``, ...)
starts with one of the ``training_layers`` prefixes; None means every
parameter (ref transfer_learning/transfer_learning.py:330-335). Where the
JAX package partitions its parameter tree and XLA drops the frozen part's
backward, the port sets ``requires_grad`` once: autograd then records no
graph for a frozen block, and its fused ops' backward kernels never
launch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from torch import nn


def is_trainable(name: str, training_layers: Optional[Sequence[str]]) -> bool:
    if training_layers is None:
        return True
    return any(name.startswith(p) for p in training_layers)


def trainable_names(model: nn.Module,
                    training_layers: Optional[Sequence[str]]) -> List[str]:
    """Sorted names of the parameters ``training_layers`` leaves trainable."""
    return sorted(n for n, _ in model.named_parameters()
                  if is_trainable(n, training_layers))


def apply_training_layers(
    model: nn.Module, training_layers: Optional[Sequence[str]]
) -> List[nn.Parameter]:
    """Set ``requires_grad`` on every parameter of ``model`` from
    ``training_layers``; returns the trainable parameters in module order.
    A parameter that becomes frozen loses its ``.grad``."""
    trainable = []
    for name, p in model.named_parameters():
        on = is_trainable(name, training_layers)
        p.requires_grad_(on)
        if on:
            trainable.append(p)
        else:
            p.grad = None
    return trainable
