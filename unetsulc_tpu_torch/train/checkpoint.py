"""Checkpoint / resume (counterpart of ``unetsulc_tpu/train/checkpoint.py``).

The reference keeps its best weights in memory and writes artifacts only
at the end of the whole CV run, so a crash mid-CV loses everything. Here:

* **epoch level** — :class:`TrainCheckpointer` snapshots the training
  state with ``torch.save`` every N epochs: each :class:`TrainState` as its
  model's ``state_dict``, its optimizer's (lr and momentum buffers), its
  step and its trainable set; plain ``state_dict``s (the best weights) as
  they are; and a JSON sidecar (epoch, controller states, best so far).
  ``learning()`` resumes from the latest snapshot.
* **fold level** — the CV driver persists results after every fold and
  skips completed folds on restart (``experiment/driver.py``).

``.mdsm`` + ``params.json`` stay the interchange format; the snapshot is
the in-training format.
"""

from __future__ import annotations

import json
import os
import os.path as op
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from unetsulc_tpu_torch.train.step import TrainState


def _to_host(tree: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, TrainState):
            out[key] = {
                "kind": "train_state",
                "model": {k: v.detach().cpu()
                          for k, v in val.model.state_dict().items()},
                "optimizer": val.optimizer.state_dict(),
                "step": int(val.step),
                "training_layers": (None if val.training_layers is None
                                    else list(val.training_layers)),
            }
        else:
            out[key] = {"kind": "state_dict",
                        "tensors": {k: v.detach().cpu() for k, v in val.items()}}
    return out


class TrainCheckpointer:
    def __init__(self, directory: str, keep: int = 2):
        self.directory = op.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _epoch_dir(self, epoch: int) -> str:
        return op.join(self.directory, f"epoch_{epoch:05d}")

    def epochs(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("epoch_") and op.exists(
                op.join(self.directory, d, "meta.json")
            ):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def save(self, epoch: int, tree: Dict[str, Any],
             extra: Optional[dict] = None) -> None:
        """Snapshot ``tree`` (name -> TrainState or state_dict) and a
        JSON-serializable ``extra``; keeps the newest ``keep`` epochs."""
        path = self._epoch_dir(epoch)
        tmp = path + ".tmp"
        if op.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(_to_host(tree), op.join(tmp, "state.pt"))
        with open(op.join(tmp, "meta.json"), "w") as f:
            json.dump({"epoch": epoch, "extra": extra or {}}, f)
        if op.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        for old in self.epochs()[: -self.keep]:
            shutil.rmtree(self._epoch_dir(old), ignore_errors=True)

    def latest(self) -> Optional[int]:
        eps = self.epochs()
        return eps[-1] if eps else None

    def restore(self, template: Dict[str, Any],
                epoch: Optional[int] = None) -> Tuple[int, Dict[str, Any], dict]:
        """(epoch, tree, extra). ``template`` names what to restore: a
        TrainState there is restored in place (its trainable set, weights,
        lr, momentum buffers and step) and returned; a state_dict comes
        back as the saved tensors on the template's devices."""
        if epoch is None:
            epoch = self.latest()
        assert epoch is not None, "no checkpoint found"
        path = self._epoch_dir(epoch)
        saved = torch.load(op.join(path, "state.pt"), map_location="cpu",
                           weights_only=True)
        tree = {}
        for key, val in template.items():
            snap = saved[key]
            if isinstance(val, TrainState):
                val.repartition(snap["training_layers"])
                val.model.load_state_dict(snap["model"], strict=True)
                val.optimizer.load_state_dict(snap["optimizer"])
                val.step = snap["step"]
                tree[key] = val
            else:
                tree[key] = {k: snap["tensors"][k].to(v.device)
                             for k, v in val.items()}
        with open(op.join(path, "meta.json")) as f:
            meta = json.load(f)
        return meta["epoch"], tree, meta.get("extra", {})
