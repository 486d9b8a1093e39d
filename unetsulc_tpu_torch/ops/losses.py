"""Masked cross-entropy, torch ``CrossEntropyLoss(ignore_index=-1)``
semantics.

Counterpart of ``unetsulc_tpu/ops/losses.py``: the reference's criterion
(ref training.py:141) takes raw logits, ignores voxels labelled -1 and
mean-reduces over the remaining voxels. The division is by the count of
valid voxels, not the volume size, and a batch with no valid voxel gives
a loss of 0, not NaN. Logits are taken in f32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def cross_entropy_sum(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(NLL sum, valid voxel count) over voxels whose label is not
    ``ignore_index``. logits: (..., C); labels: (...) integer. Callers that
    combine volumes divide the summed NLL by the summed count: the exact
    batch mean."""
    valid = labels != ignore_index
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, -1)
    picked = torch.gather(
        logits32, -1, torch.where(valid, labels, 0).long()[..., None]
    )[..., 0]
    nll = torch.where(valid, lse - picked, 0.0)
    return nll.sum(), valid.sum()


def cross_entropy_ignore(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1
) -> torch.Tensor:
    """Mean cross-entropy over the voxels whose label is not
    ``ignore_index``; 0 when there is none."""
    nll, count = cross_entropy_sum(logits, labels, ignore_index)
    return nll / count.clamp_min(1)
