"""Typed configuration — the ``parameters.json`` public API.

Parses the exact schema the reference's CLI consumes (ref main.py:24-63,
README.md:26-57) into dataclasses, reproducing the layered defaulting of
``UnetPatternSulciLabelling.__init__`` (ref pattern_class.py:64-99) and
``fill_dict_model`` (ref pattern_class.py:141-175).  The JAX package's own
knobs live in the optional ``tpu`` sub-dict and default sensibly, so a
reference ``parameters.json`` is accepted verbatim.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Union

# Hardcoded BrainVISA container fallback paths for the pretrained human
# model (ref pattern_class.py:152-172).  Kept for drop-in compatibility;
# they simply won't exist outside the container.
_BV_SHARE = "/casa/host/build/share/brainvisa-share-5.1/models/models_2019/cnn_models"
_DEFAULT_PARAMS = {
    "L": f"{_BV_SHARE}/sulci_unet_model_params_left.json",
    "R": f"{_BV_SHARE}/sulci_unet_model_params_right.json",
}
_DEFAULT_MODELS = {
    "L": f"{_BV_SHARE}/sulci_unet_model_left.mdsm",
    "R": f"{_BV_SHARE}/sulci_unet_model_right.mdsm",
}


@dataclasses.dataclass
class ModelConfig:
    """``dict_model`` — architecture + transfer-freezing config.

    Field-by-field defaults mirror ref pattern_class.py:64-99 and
    transfer_learning/transfer_learning.py:58-77.
    """

    name: str = "UnknownModel"
    num_filter: int = 64            # init_channel_number
    num_channel: int = 1            # in_channels
    interpolate: bool = True
    final_sigmoid: bool = False
    conv_layer_order: str = "crg"
    num_conv: int = 1
    dropout: float = 0.0  # deepsulci UNet3D exposes it (ref training.py:66)
    training_layers: List[str] = dataclasses.field(
        default_factory=lambda: ["final_conv"]
    )
    fine_tunning_layers: List[str] = dataclasses.field(
        default_factory=lambda: ["decoders.2", "decoders.1", "decoders.0"]
    )

    @classmethod
    def from_dict(cls, d: dict, hemi: str = "L") -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        cfg = cls(**kwargs)
        if "name" not in d:
            cfg.name = "UnknownModel_hemi" + hemi  # ref pattern_class.py:70
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TrainedModelConfig:
    """``dict_trained_model`` — the pretrained checkpoint to transfer from.

    Auto-completion semantics of ``fill_dict_model``
    (ref pattern_class.py:141-175): ``out_channels`` given as a str is a
    path to a params.json whose ``sulci_side_list`` length is used; missing
    fields fall back to BrainVISA container defaults.
    """

    in_channels: int = 1
    out_channels: Optional[Union[int, str]] = None
    final_sigmoid: bool = False
    interpolate: bool = True
    conv_layer_order: str = "crg"
    init_channel_number: int = 64
    model_file: Optional[str] = None
    num_conv: int = 1

    @classmethod
    def from_dict(cls, d: dict, hemi: str = "L") -> "TrainedModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in known})
        if isinstance(cfg.out_channels, str):
            with open(cfg.out_channels, "r") as f:
                param = json.load(f)
            cfg.out_channels = len(param["sulci_side_list"])
        elif cfg.out_channels is None:
            path = _DEFAULT_PARAMS[hemi]
            if os.path.exists(path):
                with open(path, "r") as f:
                    cfg.out_channels = len(json.load(f)["sulci_side_list"])
        if cfg.model_file is None:
            cfg.model_file = _DEFAULT_MODELS[hemi]
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TpuConfig:
    """The ``tpu`` sub-dict of ``parameters.json`` (no reference
    counterpart), under the JAX package's key so the same files parse.

    The port reads ``compute_dtype``, ``shape_buckets``, ``device_vote``,
    ``pallas_blocks`` (the model's ``fused_blocks``: False sends every
    input to the non-fused path), ``spatial_parallel`` (the sp step on a
    mesh of that many cards), ``prefetch``, ``reset_momentum_on_divide``,
    ``checkpoint_every``, ``resume``, ``evaluate``, ``augment`` and
    ``sp_shard_middle`` / ``sp_shard_deep``. ``data_parallel`` > 1 and
    ``fold_parallel`` > 1 raise ``NotImplementedError`` (not ported:
    ROADMAP.md §1 item 5); ``pallas_groupnorm``, ``sp_pallas_cpu`` and
    ``remat`` configure nothing in the port."""

    # compute dtype of the convs and matmuls ('bfloat16' or 'float32');
    # GroupNorm statistics and parameters stay float32 either way
    compute_dtype: str = "bfloat16"
    data_parallel: int = 0
    spatial_parallel: int = 1
    # batch-1 volumes go to the smallest cubic shape bucket that holds
    # them; False = one fixed size, like the reference's batch > 1 path
    shape_buckets: bool = True
    pallas_groupnorm: bool = True
    pallas_blocks: bool = True
    sp_pallas_cpu: bool = False
    sp_shard_middle: bool = True
    sp_shard_deep: bool = True
    fold_parallel: int = 1
    prefetch: int = 2
    # the threshold sweep votes on the device (train/step.py
    # make_vote_fn): only ypred and the per-part vote tables reach the
    # host. False = fetch the scores and cut on the host (ops/cutting.py)
    device_vote: bool = True
    reset_momentum_on_divide: bool = True
    remat: bool = False
    checkpoint_every: int = 0
    resume: bool = False
    evaluate: bool = False
    augment: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "TpuConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class Parameters:
    """Top-level parameters.json (ref main.py:33-63, README.md:26-57)."""

    working_path: str = "."
    learning: str = "training"       # 'transfer_learning' or anything else
    # the device (ref pattern_class.py:108-114): -1 the CPU, N cuda:N;
    # absent (None) the card, so a file that says nothing never runs on
    # the CPU. Parameters.device() resolves it; --device on the CLI wins
    cuda: Optional[int] = None
    cohort_name: str = ""
    hemi: str = "L"
    batch_size: int = 1
    lr: float = 0.01
    momentum: float = 0.9
    n_cvinner: int = 3
    n_epochs: int = 2
    th_range: List[int] = dataclasses.field(default_factory=list)
    dict_model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    dict_trained_model: Optional[TrainedModelConfig] = None
    patience: Dict[str, int] = dataclasses.field(default_factory=dict)
    translation_file: Optional[str] = None
    tpu: TpuConfig = dataclasses.field(default_factory=TpuConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "Parameters":
        hemi = d.get("hemi", "L")
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if f.name == "dict_model":
                v = ModelConfig.from_dict(v, hemi)
            elif f.name == "dict_trained_model":
                v = TrainedModelConfig.from_dict(v, hemi)
            elif f.name == "tpu":
                v = TpuConfig.from_dict(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    @classmethod
    def from_file(cls, path: str) -> "Parameters":
        with open(path, "r") as f:
            return cls.from_dict(json.load(f))

    def device(self) -> str:
        """The torch device ``cuda`` names: ``"cpu"`` for a negative index,
        ``"cuda:N"`` for N, ``"cuda"`` when the file gives none."""
        if self.cuda is None:
            return "cuda"
        return "cpu" if int(self.cuda) < 0 else f"cuda:{int(self.cuda)}"

    def cohort_file(self) -> str:
        # ref main.py:71
        return f"cohort-{self.cohort_name}_hemi-{self.hemi}"
