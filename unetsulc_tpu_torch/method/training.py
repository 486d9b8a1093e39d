"""From-scratch training method (counterpart of
``unetsulc_tpu/method/training.py``; ref training.py:33-299).

``learning()`` keeps the reference's observable behavior — results schema,
tensorboard tags, best weights by validation accuracy, the DivideLr and
EarlyStopping hooks, the optimizer rebuild on a division — on the port's
steps:

* :func:`_route_steps` picks the train and eval steps for the model and
  the ``tpu`` settings, as the JAX package's ``_cached_steps`` does, and
  returns the routing record that ``results['tpu']`` keeps per fold;
* per batch, one step on the device (forward, masked CE, backward, SGD
  with momentum, confusion counts) with no host sync: losses and counts
  are summed on the device and fetched once per epoch;
* the batches come from :func:`data.pipeline.device_iterator`: voxelized
  in a background thread, copied to the card from pinned memory on the
  method's stream;
* with ``tpu.data_parallel > 1`` each batch is padded to a multiple of
  the data axis (``alloc_batch``) and cut over the mesh's data rows
  (:func:`parallel.shard_batch`), the rows' gradients meeting in the home
  parameters;
* with ``tpu.spatial_parallel > 1`` each volume's X axis is split over
  the mesh's space shards: on the sharded fused pipeline where the model
  and the axis allow it, else on the non-fused path with halo exchanges
  (:mod:`parallel.halo`), as the JAX package falls back to its
  ``pjit_auto_spmd`` XLA step.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from unetsulc_tpu_torch.data.dataset import SulciDataset
from unetsulc_tpu_torch.data.pipeline import (
    choose_static_size,
    device_iterator,
    iterate_batches,
)
from unetsulc_tpu_torch.experiment.tensorboard import SummaryWriter
from unetsulc_tpu_torch.method.base import SulciLabeller
from unetsulc_tpu_torch.ops.esi import esi_from_counts
from unetsulc_tpu_torch.parallel import (
    make_mesh,
    shard_batch,
    shard_x,
    sp_static_shapes_ok,
)
from unetsulc_tpu_torch.train.controllers import DivideLr, EarlyStopping
from unetsulc_tpu_torch.train.step import (
    TrainState,
    make_eval_step,
    make_eval_step_dp,
    make_eval_step_sp,
    make_eval_step_sp_halo,
    make_train_step,
    make_train_step_dp,
    make_train_step_sp,
    make_train_step_sp_halo,
)
from unetsulc_tpu_torch.utils.profiling import EpochTimer, HostSpans, span


def _route_steps(model, num_classes: int, momentum: float, dp: int = 1,
                 spatial: int = 1, devices=None):
    """(train_step, eval_step, mesh or None, record) for ``model``.

    The record has the JAX package's keys, with the port's own values:

    * ``step``: ``"single_device"``; ``"dp_mesh"``, the data-parallel step
      (``make_train_step_dp``) on a mesh of ``dp`` data rows;
      ``"sp_mesh"``, the sharded fused step of ``parallel/``
      (``make_train_step_sp``) on ``dp`` rows of ``spatial`` shards; or
      ``"sp_halo"``, the sharded non-fused step
      (``make_train_step_sp_halo``, the JAX package's ``pjit_auto_spmd``)
      on that mesh, for a request the sharded fused pipeline cannot take:
      a model off the fused path, or a space axis outside {2, 4, 8}. One
      process drives every shard. The mesh takes ``devices`` (a fold's
      device group) when given, else shard i goes to ``cuda:i``; on the
      CPU every shard is on the CPU;
    * ``kernels``: ``"fused"`` when the step runs the fused pipeline
      (kernels A-E on the card, their plain versions on the CPU),
      ``"nonfused"`` otherwise (cuDNN convs and the GroupNorm kernels);
    * ``data_parallel``, ``spatial_parallel``: the requested sizes;
    * ``sp_fallback``: True exactly when a ``spatial_parallel`` request
      does not take the sharded fused pipeline (``"sp_halo"``), where the
      JAX package's record has it.
    """
    fused = model.fused_config()
    halo = spatial > 1 and not (fused and sp_static_shapes_ok(spatial))
    record = {
        "step": ("sp_halo" if halo else "sp_mesh" if spatial > 1
                 else "dp_mesh" if dp > 1 else "single_device"),
        "kernels": "fused" if fused and not halo else "nonfused",
        "data_parallel": dp,
        "spatial_parallel": spatial,
        "sp_fallback": halo,
    }
    final_sigmoid = model.final_sigmoid
    if halo:
        # the JAX package's notice for its pjit_auto_spmd fallback
        print(f"spatial_parallel={spatial}: config ineligible for the "
              "sharded fused pipeline (needs a bf16 'crg' interpolating "
              "model without dropout, a space axis in {2, 4, 8}); using "
              "the sharded non-fused path with halo exchanges")
    if dp <= 1 and spatial <= 1:
        return (make_train_step(model, num_classes, momentum=momentum),
                make_eval_step(model, num_classes, final_sigmoid=final_sigmoid),
                None, record)
    dev = model.device
    if devices is None and dev.type == "cpu":
        devices = [dev] * (dp * spatial)
    mesh = make_mesh(data=dp, space=spatial, devices=devices)
    if mesh.home != dev:
        raise ValueError(f"the model lives on {dev}, the mesh's home "
                         f"device is {mesh.home}")
    if halo:
        return (make_train_step_sp_halo(model, num_classes, mesh,
                                        momentum=momentum),
                make_eval_step_sp_halo(model, num_classes, mesh,
                                       final_sigmoid=final_sigmoid),
                mesh, record)
    if spatial > 1:
        return (make_train_step_sp(model, num_classes, mesh, momentum=momentum),
                make_eval_step_sp(model, num_classes, mesh,
                                  final_sigmoid=final_sigmoid),
                mesh, record)
    return (make_train_step_dp(model, num_classes, mesh, momentum=momentum),
            make_eval_step_dp(model, num_classes, mesh,
                              final_sigmoid=final_sigmoid),
            mesh, record)


class TrainingSulciLabeller(SulciLabeller):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.results = self._results_schema()
        self._state: Optional[TrainState] = None

    @staticmethod
    def _results_schema() -> dict:
        # ref training.py:41-57
        return {
            "lr": [],
            "momentum": [],
            "batch_size": [],
            "num_epochs": [],
            "graphs_train": [],
            "graphs_test": [],
            "patience": {},
            "epoch_loss_val": [],
            "epoch_acc_val": [],
            "epoch_loss_train": [],
            "epoch_acc_train": [],
            "best_acc": [],
            "best_epoch": [],
            "divide_lr_epoch": [],
            "duration": [],
            "threshold_scores": {},
        }

    def reset_results(self) -> None:
        self.results = self._results_schema()

    # ------------------------------------------------------------------
    def load_network(self, rng_seed: int = 0) -> None:
        """A fresh UNet3D on the method's device, its weights drawn from a
        ``torch.Generator`` seeded with ``rng_seed`` (ref
        training.py:60-74)."""
        print("Network initialization...")
        self.model = self._make_model(len(self.sulci_side_list), seed=rng_seed)
        self._predict_fns = {}

    def _training_layers(self) -> Optional[Sequence[str]]:
        return None  # from scratch: everything trainable

    # ------------------------------------------------------------------
    def _epoch_pass(self, phase: str, state: TrainState, step_fn, dataset,
                    img_size, batch_size: int, epoch: int, mesh=None,
                    alloc_batch: Optional[int] = None,
                    spans: Optional[HostSpans] = None):
        """One phase of one epoch. Returns (epoch_loss, counts, perf, the
        sorted volume extents its batches had).

        Loss and confusion counts stay on the device and are fetched once,
        at the end of the phase: the steps never wait for the host.
        ``spans`` times the phase's parts on the host: the dataset's
        (``SulciDataset``), the pipeline's (``device_iterator``), the
        steps' dispatch (``step``), within it a train step's phases
        (``state.spans``, ``train/step.py``), and the end-of-phase
        ``fetch``."""
        timer = EpochTimer()
        loss_terms, count_terms, extents = [], [], set()
        dataset.spans = spans
        if phase == "train":
            state.spans = spans
        batches = iterate_batches(dataset, batch_size, img_size, epoch=epoch,
                                  alloc_batch=alloc_batch)
        for inputs, labels, real in device_iterator(
                batches, self.device, prefetch=self.tpu.prefetch,
                stream=self._stream, spans=spans):
            extents.add(tuple(int(v) for v in inputs.shape[1:4]))
            voxels = real * int(np.prod(inputs.shape[1:4]))
            if mesh is not None and mesh.data > 1:
                inputs, labels = shard_batch(mesh, inputs, labels)
            elif mesh is not None:
                inputs, labels = shard_x(inputs, mesh), shard_x(labels, mesh)
            with span(spans, "step"):
                if phase == "train":
                    loss, c = step_fn(state, inputs, labels)
                else:
                    loss, c = step_fn(inputs, labels)
            loss_terms.append(loss * real)
            count_terms.append(c)
            timer.add_batch(voxels)
        with span(spans, "fetch"):
            running_loss = float(torch.stack(loss_terms).sum())
            counts = torch.stack(count_terms).sum(0).cpu().numpy().astype(
                np.int64)
        return (running_loss / len(dataset), counts, timer.finish(),
                sorted(extents))

    def _controllers(self, patience: Dict[str, int]):
        ctrl = {}
        if "early_stopping" in patience:
            ctrl["early_stopping"] = EarlyStopping(
                patience=patience["early_stopping"])
        if "divide_lr" in patience:
            ctrl["divide_lr"] = DivideLr(patience=patience["divide_lr"])
        return ctrl

    def _best_copy(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    # ------------------------------------------------------------------
    def learning(
        self,
        lr: float,
        momentum: float,
        num_epochs: int,
        gfile_list_train: Sequence[str],
        gfile_list_test: Sequence[str],
        batch_size: int = 1,
        patience: Optional[Dict[str, int]] = None,
        save_results: bool = True,
    ):
        patience = patience or {}
        if (self.sulci_side_list is None or self.dict_bck2 is None
                or self.dict_names is None):
            print("Error : extract data from graphs before learning")
            return 1

        # # DATASETS # #
        # batch 1 with shape buckets: each sample in its cubic bucket (the
        # counterpart of the reference's batch-1 dynamic sizes); batch > 1:
        # one fixed size per dataset, as the reference records it. Under
        # data parallelism, samples of one bucket are grouped into batches
        # padded to a multiple of the data axis with all-background
        # samples (the JAX package's choice: no reference counterpart)
        dp = max(1, self.tpu.data_parallel)
        per_sample = self.tpu.shape_buckets and (batch_size == 1 or dp > 1)
        alloc_batch = -(-batch_size // dp) * dp if dp > 1 else None

        print("Extract validation dataloader...")
        valdataset = SulciDataset(
            gfile_list_test, self.dict_sulci, train=False,
            translation_file=self.trfile, dict_bck2=self.dict_bck2,
            dict_names=self.dict_names)
        if per_sample:
            val_img_size = None
            print("Val dataset image size: per-sample buckets")
        else:
            val_img_size = choose_static_size(valdataset)
            valdataset.img_size = list(val_img_size)
            print("Val dataset image size:", list(val_img_size))

        print("Extract train dataloader...")
        traindataset = SulciDataset(
            gfile_list_train, self.dict_sulci, train=self.tpu.augment,
            translation_file=self.trfile, dict_bck2=self.dict_bck2,
            dict_names=self.dict_names,
            seed=42)  # the reference's fixed augmentation seed
        if per_sample:
            train_img_size = None
            print("Train dataset image size: per-sample buckets")
        else:
            train_img_size = choose_static_size(traindataset,
                                                num_epochs=num_epochs)
            traindataset.img_size = list(train_img_size)
            print("Train dataset image size:", list(train_img_size))

        # # MODEL + STATE # #
        self._prepare_model_and_state(lr)
        num_classes = len(self.sulci_side_list)
        train_step, eval_step, mesh, record = _route_steps(
            self.model, num_classes, momentum, dp=dp,
            spatial=self.tpu.spatial_parallel, devices=self.devices)
        state = self._state

        # # RESULTS / TENSORBOARD # #
        writer = None
        num_training = len(self.results["lr"])
        if save_results:
            self.results["lr"].append(lr)
            self.results["momentum"].append(momentum)
            self.results["batch_size"].append(batch_size)
            self._append_epoch_count(num_epochs)
            self.results["graphs_test"].append(list(gfile_list_test))
            self.results["graphs_train"].append(list(gfile_list_train))
            self.results["patience"] = patience
            self.results.setdefault("tpu", []).append(dict(record))
            if batch_size > 1 and train_img_size is not None:
                # ref training.py:152-158 records the fixed sizes: fold 0
                # flat, later folds appended as lists
                sizes = ([int(i) for i in train_img_size],
                         [int(i) for i in val_img_size])
                if num_training == 0:
                    self.results["train_image_size"] = sizes[0]
                    self.results["val_image_size"] = sizes[1]
                else:
                    self.results["train_image_size"].append(sizes[0])
                    self.results["val_image_size"].append(sizes[1])
            log_dir = os.path.join(self.working_path, "tensorboard",
                                   self.model_name)
            os.makedirs(log_dir, exist_ok=True)
            # a fold of a fold-parallel run starts a fresh method:
            # cv_index_offset restores its true index on disk
            writer = SummaryWriter(log_dir=os.path.join(
                log_dir, "cv" + str(self.cv_index_offset + num_training)))

        ctrl = self._controllers(patience)

        # # TRAINING # #
        print("training...")
        since = time.time()
        best_params = self._best_copy()
        best_acc, best_epoch = 0.0, 0
        sslist_ids = [self.dict_sulci[ss] for ss in self.sslist]
        epoch_loss = 0.0

        # epoch-level checkpoints and resume (no reference counterpart)
        ckptr = None
        start_epoch = 0
        curve_keys = [f"epoch_{m}_{p}" for m in ("loss", "acc")
                      for p in ("train", "val")]
        if self.tpu.checkpoint_every > 0:
            from unetsulc_tpu_torch.train.checkpoint import TrainCheckpointer

            ckptr = TrainCheckpointer(os.path.join(
                self.working_path, "checkpoints", self.model_name,
                f"cv{self.cv_index_offset + num_training}"))
            if self.tpu.resume and ckptr.latest() is not None:
                _, tree, extra = ckptr.restore(
                    {"state": state, "best": best_params})
                best_params = tree["best"]
                start_epoch = extra["epoch"] + 1
                best_acc = extra["best_acc"]
                best_epoch = extra["best_epoch"]
                for k, cstate in extra.get("controllers", {}).items():
                    if k in ctrl:
                        ctrl[k].__dict__.update(cstate)
                if save_results:
                    for key in curve_keys:
                        fold_curve = list(extra["fold_results"].get(key, []))
                        if len(self.results[key]) <= num_training:
                            self.results[key].append(fold_curve)
                        else:
                            self.results[key][num_training] = fold_curve
                    for key in ("divide_lr_epoch", "fine_tunning_epoch"):
                        if key in extra and key in self.results:
                            self.results[key] = extra[key]
                print(f"Resumed from checkpoint at epoch {start_epoch - 1}")

        stop = False
        for epoch in range(start_epoch, num_epochs):
            print("Epoch {}/{}".format(epoch, num_epochs - 1))
            print("-" * 10)
            start_time = time.time()

            for phase in ["train", "val"]:
                train = phase == "train"
                epoch_loss, counts, perf, extents = self._epoch_pass(
                    phase, state, train_step if train else eval_step,
                    traindataset if train else valdataset,
                    train_img_size if train else val_img_size,
                    batch_size, epoch, mesh, alloc_batch)
                epoch_acc = 1 - esi_from_counts(counts, sslist_ids)
                print("{} Loss: {:.4f} Acc: {:.4f} ({:,.0f} voxels/s, "
                      "{:.2f} s; volumes {})".format(
                          phase, epoch_loss, epoch_acc,
                          perf["voxels_per_sec"], perf["seconds"],
                          ", ".join("x".join(map(str, e)) for e in extents)))
                if save_results:
                    self.results.setdefault(
                        "voxels_per_sec_" + phase, []).append(
                            perf["voxels_per_sec"])
                    writer.add_scalar("Loss/" + phase, epoch_loss, epoch)
                    writer.add_scalar("Accuracy/" + phase, epoch_acc, epoch)
                    # the fold's first epoch opens its list (on resume the
                    # restored list is appended to)
                    for key, val in (("epoch_loss_" + phase, epoch_loss),
                                     ("epoch_acc_" + phase, epoch_acc)):
                        if len(self.results[key]) <= num_training:
                            self.results[key].append([val])
                        else:
                            self.results[key][num_training].append(val)

                if phase == "val" and epoch_acc > best_acc:
                    best_acc = epoch_acc
                    best_epoch = epoch
                    best_params = self._best_copy()

            # the controllers read the val loss (the reference's
            # epoch_loss holds the val phase's value here)
            state, stop = self._post_epoch(ctrl, epoch, num_epochs,
                                           epoch_loss, state, save_results)
            if ckptr is not None and (epoch + 1) % self.tpu.checkpoint_every == 0:
                extra = {
                    "epoch": epoch,
                    "best_acc": float(best_acc),
                    "best_epoch": int(best_epoch),
                    "controllers": {
                        k: {kk: vv for kk, vv in c.__dict__.items()
                            if isinstance(vv, (int, float, bool, type(None)))}
                        for k, c in ctrl.items()
                    },
                    "fold_results": {
                        key: self.results[key][num_training]
                        for key in curve_keys
                        if save_results and len(self.results[key]) > num_training
                    },
                }
                for key in ("divide_lr_epoch", "fine_tunning_epoch"):
                    if key in self.results:
                        extra[key] = self.results[key]
                ckptr.save(epoch, {"state": state, "best": best_params}, extra)
            print("Epoch took %i s." % (time.time() - start_time))
            print("\n")
            if stop:
                break

        time_elapsed = time.time() - since
        print("Training complete in {:.0f}m {:.0f}s".format(
            time_elapsed // 60, time_elapsed % 60))
        print("Best val Acc: {:4f}, Epoch {}".format(best_acc, best_epoch))

        if save_results:
            self.results["best_acc"].append(best_acc)
            self.results["best_epoch"].append(best_epoch)
            self.results["duration"].append(time_elapsed)
            writer.close()

        # load the best weights (ref training.py:276)
        self.model.load_state_dict(best_params)
        self._state = None
        return 0

    # hooks overridden by the transfer subclass -------------------------
    def _append_epoch_count(self, num_epochs: int) -> None:
        self.results["num_epochs"].append(num_epochs)

    def _prepare_model_and_state(self, lr: float) -> None:
        self.load_network()
        self._state = TrainState.create(
            self.model, lr=lr, training_layers=self._training_layers())

    def _post_epoch(self, ctrl, epoch, num_epochs, epoch_loss, state,
                    save_results):
        stop = False
        if "divide_lr" in ctrl:
            ctrl["divide_lr"](epoch_loss)
            if ctrl["divide_lr"].divide_lr:
                state = state.divide_lr(
                    10.0, reset_momentum=self.tpu.reset_momentum_on_divide)
                print("\tDivide learning rate. New value: {}".format(
                    float(state.lr)))
                self.results["divide_lr_epoch"].append(epoch)
        if "early_stopping" in ctrl:
            ctrl["early_stopping"](epoch_loss)
            if ctrl["early_stopping"].early_stop:
                print("Early stopping")
                stop = True
        return state, stop
