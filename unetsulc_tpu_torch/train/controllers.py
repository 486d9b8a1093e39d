"""Host-side training controllers: plateau detectors driving lr / freezing.

Pure-Python state machines, deliberately framework-free (they look at one
scalar per epoch).  Semantics are pinned to the reference:

* :class:`EarlyStopping` — ``deepsulci.deeptools.early_stopping`` contract
  (ref training.py:166,255-259): after ``patience`` consecutive epochs
  without val-loss improvement, sets ``early_stop``.
* :class:`DivideLr` — ref divide_lr.py:9-69: same machinery; on trigger the
  counter resets and ``repeat`` bounds how many divisions may fire; the
  *caller* divides lr by 10 and rebuilds the optimizer (which resets
  momentum — reference behavior we keep configurable,
  ref training.py:246-253).
* :class:`FineTunning` — ref fine_tunning.py:9-65: one-shot trigger that
  unfreezes ``fine_tunning_layers`` and divides lr
  (ref transfer_learning/transfer_learning.py:381-394).

"Improvement" is strict (score <= best counts as no improvement when score
< best; equal scores update best — exactly the reference's comparisons).
Optional checkpointing on improvement writes ``checkpoint.mdsm`` with
``torch.save`` (the reference's never-enabled ``checkpoint.pt`` path,
ref divide_lr.py:63-69). A copy of ``unetsulc_tpu/train/controllers.py``.
"""

from __future__ import annotations

import os.path as op
from typing import Callable, Optional

import numpy as np


class _PlateauDetector:
    def __init__(
        self,
        patience: int = 7,
        verbose: bool = False,
        save: bool = False,
        savepath: str = "",
    ):
        self.patience = patience
        self.verbose = verbose
        self.counter = 0
        self.best_score: Optional[float] = None
        self.val_loss_min = np.inf
        self.save = save
        self.savepath = savepath

    def _save_checkpoint(self, val_loss: float, get_state: Optional[Callable]):
        if get_state is None:
            return
        import torch

        if self.verbose:
            print(
                "Validation loss decreased (%.6f -> %.6f). Saving model..."
                % (self.val_loss_min, val_loss)
            )
        torch.save(get_state(), op.join(self.savepath, "checkpoint.mdsm"))
        self.val_loss_min = val_loss


class EarlyStopping(_PlateauDetector):
    """Stop training after ``patience`` epochs without val-loss improvement."""

    def __init__(self, patience: int = 7, **kw):
        super().__init__(patience, **kw)
        self.early_stop = False

    def __call__(self, val_loss: float, get_state: Optional[Callable] = None):
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
            if self.save:
                self._save_checkpoint(val_loss, get_state)
        elif score < self.best_score:
            self.counter += 1
            print(
                "EarlyStopping counter: %i out of %i"
                % (self.counter, self.patience)
            )
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            if self.save:
                self._save_checkpoint(val_loss, get_state)
            self.counter = 0


class DivideLr(_PlateauDetector):
    """Request an lr division after a val-loss plateau (ref divide_lr.py)."""

    def __init__(self, patience: int = 7, repeat: int = 1, **kw):
        super().__init__(patience, **kw)
        self.stop = False
        self.divide_lr = False
        self.repeat = repeat

    def __call__(self, val_loss: float, get_state: Optional[Callable] = None):
        self.divide_lr = False
        if self.stop:
            return
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
            if self.save:
                self._save_checkpoint(val_loss, get_state)
        elif score < self.best_score:
            self.counter += 1
            print(
                "DivideLr counter: %i out of %i" % (self.counter, self.patience)
            )
            if self.counter >= self.patience:
                self.divide_lr = True
                self.repeat -= 1
                self.counter = 0
        else:
            self.best_score = score
            if self.save:
                self._save_checkpoint(val_loss, get_state)
            self.counter = 0
        if self.repeat <= 0:
            self.stop = True


class FineTunning(_PlateauDetector):
    """One-shot fine-tuning trigger (ref fine_tunning.py)."""

    def __init__(self, patience: int = 7, **kw):
        super().__init__(patience, **kw)
        self.stop = False
        self.ft_start = False

    def __call__(self, val_loss: float, get_state: Optional[Callable] = None):
        if self.stop:
            self.ft_start = False
            return
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
            if self.save:
                self._save_checkpoint(val_loss, get_state)
        elif score < self.best_score:
            self.counter += 1
            print(
                "FineTunning counter: %i out of %i"
                % (self.counter, self.patience)
            )
            if self.counter >= self.patience:
                self.ft_start = True
                self.stop = True
        else:
            self.best_score = score
            if self.save:
                self._save_checkpoint(val_loss, get_state)
            self.counter = 0
