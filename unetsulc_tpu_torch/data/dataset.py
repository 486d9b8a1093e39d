"""Dataset classes: graph files -> dense voxel samples.

Copies of the JAX package's ``SulciDataset`` and ``PatternDataset`` (ref
dataset.py:15-170) with the same construction signatures and caching
behavior:

* items are numpy arrays in channels-last layout (X, Y, Z, C);
* augmentation draws from an explicit per-(epoch, index) Generator derived
  from a base seed, so any epoch's stream can be replayed without the
  reference's global ``random.seed(42)`` re-seeding dance
  (ref training.py:120-136);
* point extraction results are cached in ``dict_bck2`` / ``dict_names``
  exactly like the reference (ref dataset.py:45-62), so graph I/O happens
  once per file.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from unetsulc_tpu_torch.data.extract import extract_data
from unetsulc_tpu_torch.data.geometry import (
    apply_bounding_box,
    augment_points,
    random_rotation,
    rotate_points,
    rotation_size_bound,
)
from unetsulc_tpu_torch.data.voxelize import names_to_ids, voxelize
from unetsulc_tpu_torch.io.container import read_graph
from unetsulc_tpu_torch.io.translation import FoldLabelsTranslator
from unetsulc_tpu_torch.utils.profiling import span


class SulciDataset:
    """Voxel dataset for sulcus labelling (ref dataset.py:15-91).

    ``__getitem__`` returns ``(input, labels)``:
    input (X, Y, Z, 1) float32, labels (X, Y, Z) int32 with background -1.
    With ``spans`` set (a :class:`~unetsulc_tpu_torch.utils.profiling.HostSpans`)
    it times its parts: ``points`` (the cached point lists as arrays),
    ``augment`` (translation and augmentation), ``ids`` (the label ids) and
    ``voxelize``.
    """

    ROT_ANGLE = math.pi / 16  # ref dataset.py:27

    def __init__(
        self,
        gfile_list: Sequence[str],
        dict_sulci: Dict[str, int],
        train: bool = True,
        translation_file: Optional[str] = None,
        dict_bck2: Optional[dict] = None,
        dict_names: Optional[dict] = None,
        img_size: Optional[Sequence[int]] = None,
        seed: int = 0,
    ):
        self.gfile_list = list(gfile_list)
        self.dict_sulci = dict(dict_sulci)
        if "background" not in self.dict_sulci:
            self.dict_sulci["background"] = -1
        self.train = train
        self.rot_angle = self.ROT_ANGLE
        self.translation_file = translation_file
        self.dict_bck2 = dict_bck2 if dict_bck2 is not None else {}
        self.dict_names = dict_names if dict_names is not None else {}
        self.img_size = list(img_size) if img_size is not None else None
        self.seed = seed
        self.epoch = 0  # bump via set_epoch for a fresh augmentation stream
        self.spans = None  # HostSpans of __getitem__'s parts, when set

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _load_points(self, gfile: str):
        if gfile in self.dict_bck2:
            bck2 = np.asarray(self.dict_bck2[gfile])
            names = np.asarray(self.dict_names[gfile])
        else:
            graph = read_graph(gfile)
            if self.translation_file is not None:
                flt = FoldLabelsTranslator()
                flt.readLabels(self.translation_file)
                flt.translate(graph)
            data = extract_data(graph)
            bck2 = np.asarray(data["bck2"])
            names = np.asarray(data["names"])
            self.dict_bck2[gfile] = bck2
            self.dict_names[gfile] = names
        return bck2, names

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, index])
        )

    def __getitem__(self, index: int):
        gfile = self.gfile_list[index]
        with span(self.spans, "points"):
            bck2, names = self._load_points(gfile)

        with span(self.spans, "augment"):
            bck2 = bck2 - np.min(bck2, axis=0)  # translate to origin
            if self.train:
                bck2 = augment_points(bck2, self.rot_angle, self._rng(index))
            bck2 = np.asarray(bck2, dtype=np.int64)

        with span(self.spans, "ids"):
            label_ids = names_to_ids(names, self.dict_sulci)
        with span(self.spans, "voxelize"):
            return voxelize(bck2, label_ids, img_size=self.img_size)

    def __len__(self) -> int:
        return len(self.gfile_list)

    def sample_extent(self, index: int) -> int:
        """Max per-axis extent of sample ``index`` at the CURRENT epoch,
        without voxelizing (pure point math).

        Replays the same per-(seed, epoch, index) augmentation draw that
        ``__getitem__`` will use, so the value is exact — this is what lets
        the input pipeline group same-bucket samples into data-parallel
        batches (data.pipeline.iterate_batches) without a voxelization
        pre-pass."""
        bck2, _ = self._load_points(self.gfile_list[index])
        bck2 = bck2 - np.min(bck2, axis=0)
        if self.train:
            bck2 = augment_points(bck2, self.rot_angle, self._rng(index))
        return int(np.max(bck2)) + 1

    def max_image_size(self, num_epochs: Optional[int] = None) -> np.ndarray:
        """Static per-axis size bound for the whole dataset.

        Eval datasets: the exact ``max(bck2)+1`` (ref training.py:96-99).

        Train datasets with ``num_epochs``: the EXACT maximum over the
        augmentation stream that training will replay — our per-(seed,
        epoch, index) RNG makes the stream deterministic, so the scan is
        pure point math (rotate + extent), no voxelization.  This is the
        reference's empirical pre-scan (ref training.py:120-127) without
        its num_epochs x dataset of wasted dense volumes.

        Without ``num_epochs``: the analytic circumradius bound of
        :func:`rotation_size_bound` — sound for ANY rotation draw but loose
        (up to ~2x per axis for cube-like clouds).
        """
        size = np.zeros(3)
        saved_epoch = self.epoch
        for gfile in self.gfile_list:
            bck2, _ = self._load_points(gfile)
            bck2 = bck2 - np.min(bck2, axis=0)
            if not self.train:
                size = np.maximum(size, np.max(bck2, axis=0) + 1)
            elif num_epochs is None:
                size = np.maximum(
                    size, rotation_size_bound(bck2, self.rot_angle)
                )
        if self.train and num_epochs is not None:
            for epoch in range(num_epochs):
                self.epoch = epoch
                for index in range(len(self.gfile_list)):
                    bck2, _ = self._load_points(self.gfile_list[index])
                    bck2 = bck2 - np.min(bck2, axis=0)
                    aug = augment_points(
                        bck2, self.rot_angle, self._rng(index)
                    )
                    size = np.maximum(size, np.max(aug, axis=0) + 1)
            self.epoch = saved_epoch
        return size.astype(int)


class PatternDataset:
    """Binary pattern-presence classification dataset (ref dataset.py:94-170).

    Items: ``(input, label)`` with input (X, Y, Z, 1) float32 cropped to a
    fixed bounding box and label in {0, 1} (or provided labels / NaN).
    """

    ROT_ANGLE = math.pi / 40  # ref dataset.py:106
    TR_SIGMA = 2  # ref dataset.py:107

    def __init__(
        self,
        gfile_list: Sequence[str],
        pattern: Optional[str],
        bb,
        train: bool = True,
        dict_bck: Optional[dict] = None,
        dict_label: Optional[dict] = None,
        labels: Optional[List] = None,
        seed: int = 0,
    ):
        self.gfile_list = list(gfile_list)
        self.labels = labels
        self.pattern = pattern
        self.bb = np.asarray(bb)
        self.size = self.bb[:, 1] - self.bb[:, 0] + 1
        self.tr = self.bb[:, 0]
        self.train = train
        self.dict_bck = dict_bck if dict_bck is not None else {}
        self.dict_label = dict_label if dict_label is not None else {}
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, index, 1])
        )

    def __getitem__(self, index: int):
        gfile = self.gfile_list[index]
        if gfile in self.dict_bck:
            bck = self.dict_bck[gfile]
            label = self.dict_label[gfile]
        else:
            # hemisphere from the leading L/R of the file basename
            # (ref dataset.py:134-135)
            base = gfile[gfile.rfind("/") + 1 : gfile.rfind("/") + 2]
            flip = base == "R"
            graph = read_graph(gfile)
            data = extract_data(graph, flip=flip)
            bck = data["bck2"]
            if self.labels is not None:
                label = self.labels[index]
            elif self.pattern is None:
                label = float("nan")
            else:
                label = int(
                    any(str(n).startswith(self.pattern) for n in data["names"])
                )
            self.dict_bck[gfile] = bck
            self.dict_label[gfile] = label

        bck = np.asarray(bck)
        if self.train:
            rng = self._rng(index)
            center = (np.max(bck, axis=0) - np.min(bck, axis=0)) / 2
            transrot = random_rotation(center, self.ROT_ANGLE, rng)
            bck = rotate_points(bck, transrot)
            # Gaussian integer jitter (ref dataset.py:119-123)
            bck = bck + np.round(rng.normal(0, self.TR_SIGMA, size=3)).astype(int)

        bck, _ = apply_bounding_box(bck, self.bb)
        bck = bck - self.tr
        vol = np.zeros((*self.size, 1), dtype=np.float32)
        if len(bck):
            vol[bck[:, 0], bck[:, 1], bck[:, 2], 0] = 1.0
        return vol, label

    def __len__(self) -> int:
        return len(self.gfile_list)
