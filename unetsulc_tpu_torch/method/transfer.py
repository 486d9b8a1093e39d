"""Transfer-learning method (counterpart of
``unetsulc_tpu/method/transfer.py``; ref
transfer_learning/transfer_learning.py:27-610).

Starts from a pretrained ``.mdsm`` checkpoint, swaps ``final_conv`` for a
fresh head over the new label set, trains only ``training_layers``
(default ``['final_conv']``), and unfreezes ``fine_tunning_layers``
(default ``decoders.{2,1,0}``) with lr / 10 when the FineTunning plateau
trigger fires — or unconditionally at ``epoch == int(0.8 * num_epochs)``
(ref :384-386).

Freezing sets ``requires_grad`` by name prefix (``train/freeze.py``), so a
head-only step records no autograd graph for the trunk and launches no
backward kernel; the unfreeze is ``TrainState.repartition``, which
restarts momentum at zero, as the reference's optimizer rebuild does (ref
:392).
"""

from __future__ import annotations

from typing import Optional, Sequence

from unetsulc_tpu_torch.method.training import TrainingSulciLabeller
from unetsulc_tpu_torch.models.interop import load_mdsm
from unetsulc_tpu_torch.train.controllers import FineTunning
from unetsulc_tpu_torch.train.step import TrainState


class TransferSulciLabeller(TrainingSulciLabeller):
    def __init__(
        self,
        graphs,
        hemi,
        cuda: int = -1,
        working_path=None,
        dict_model=None,
        dict_trained_model=None,
        dict_names=None,
        dict_bck2=None,
        sulci_side_list=None,
        translation_file=None,
        tpu=None,
        device="cuda",
    ):
        super().__init__(
            graphs,
            hemi,
            cuda=cuda,
            working_path=working_path,
            dict_model=dict_model or {},
            dict_names=dict_names,
            dict_bck2=dict_bck2,
            sulci_side_list=sulci_side_list,
            translation_file=translation_file,
            tpu=tpu,
            device=device,
        )
        dict_model = dict_model or {}
        # freeze config (ref transfer_learning/transfer_learning.py:62-69)
        self.training_layers = list(
            dict_model.get("training_layers", ["final_conv"]))
        self.fine_tunning_layers = list(dict_model.get(
            "fine_tunning_layers", ["decoders.2", "decoders.1", "decoders.0"]))
        self.dict_trained_model = dict(dict_trained_model or {})
        self.results = self._results_schema()

    @staticmethod
    def _results_schema() -> dict:
        # ref transfer_learning/transfer_learning.py:82-97 ('num_epoch',
        # 'fine_tunning_epoch' replace the training schema's fields)
        return {
            "lr": [],
            "momentum": [],
            "batch_size": [],
            "epoch_loss_val": [],
            "epoch_loss_train": [],
            "epoch_acc_val": [],
            "epoch_acc_train": [],
            "best_acc": [],
            "best_epoch": [],
            "num_epoch": [],
            "duration": [],
            "fine_tunning_epoch": [],
            "threshold_scores": {},
            "graphs_train": [],
            "graphs_test": [],
            "patience": {},
        }

    def _append_epoch_count(self, num_epochs: int) -> None:
        self.results["num_epoch"].append(num_epochs)

    # ------------------------------------------------------------------
    def load_model(self, rng_seed: int = 42) -> None:
        """Pretrained trunk and a fresh head (ref :145-168). The model is
        built with its weights drawn from a generator seeded with
        ``rng_seed`` (the reference's ``torch.manual_seed(42)``); every
        parameter but ``final_conv``'s is then read from the ``.mdsm``."""
        print("Network initialization...")
        self.dict_trained_model = self.fill_dict_model(self.dict_trained_model)
        print("Model_file: ", self.dict_trained_model["model_file"])
        self.model = self._make_model(
            out_channels=len(self.sulci_side_list),
            in_channels=self.dict_trained_model["in_channels"],
            final_sigmoid=self.dict_trained_model["final_sigmoid"],
            interpolate=self.dict_trained_model["interpolate"],
            conv_layer_order=self.dict_trained_model["conv_layer_order"],
            init_channel_number=self.dict_trained_model["init_channel_number"],
            num_conv=self.num_conv,
            seed=rng_seed,
        )
        trunk = {k: v for k, v in load_mdsm(
            self.dict_trained_model["model_file"]).items()
            if not k.startswith("final_conv")}
        missing, unexpected = self.model.load_state_dict(trunk, strict=False)
        if unexpected or any(not k.startswith("final_conv") for k in missing):
            raise ValueError(
                f"{self.dict_trained_model['model_file']} does not match the "
                f"model: missing {missing}, unexpected {unexpected}")
        self._predict_fns = {}

    # hooks ------------------------------------------------------------
    def _training_layers(self) -> Optional[Sequence[str]]:
        return list(self.training_layers)

    def _prepare_model_and_state(self, lr: float) -> None:
        self.load_model()
        self._state = TrainState.create(
            self.model, lr=lr, training_layers=self._training_layers())

    def _controllers(self, patience):
        ctrl = super()._controllers(patience)
        ctrl.pop("divide_lr", None)  # transfer uses fine_tunning instead
        if "fine_tunning" in patience:
            ctrl["fine_tunning"] = FineTunning(
                patience=patience["fine_tunning"], save=False)
        return ctrl

    def _post_epoch(self, ctrl, epoch, num_epochs, epoch_loss, state,
                    save_results):
        stop = False
        if "fine_tunning" in ctrl:
            ft = ctrl["fine_tunning"]
            ft(epoch_loss)
            if epoch == int(0.8 * num_epochs):  # forced unfreeze (ref :384)
                ft.ft_start = True
                ft.stop = True
            if ft.ft_start:
                print("\nFine tunning")
                # extending the instance's list reproduces the reference's
                # cross-fold behavior (ref :389, one method object over all
                # CV folds): after the first fold fine-tunes, later folds
                # train the decoder layers from epoch 0
                self.training_layers += self.fine_tunning_layers
                state = state.repartition(self.training_layers).divide_lr(
                    10.0, reset_momentum=True)
                print("Divide learning rate. New value: {}\n".format(
                    float(state.lr)))
                if save_results:
                    self.results["fine_tunning_epoch"].append(epoch)
        if "early_stopping" in ctrl:
            ctrl["early_stopping"](epoch_loss)
            if ctrl["early_stopping"].early_stop:
                print("\nEarly stopping")
                stop = True
        return state, stop
