"""SulciLabeller — the shared method-layer base class.

Counterpart of ``SulciLabeller`` in ``unetsulc_tpu/method/base.py`` (ref
pattern_class.py:32-368) with the same public API:
``extract_data_from_graphs``, ``fill_dict_model``, ``test_thresholds``,
``labeling``, ``save_data``, ``save_model``, ``save_results``,
``save_params``, ``reset_results``, ``load_saved_model``. The model is the
port's ``UNet3D`` (``self.model``); ``.mdsm`` files are its ``state_dict``
written with ``torch.save``, and every JSON artifact keeps the reference's
schema.

The model runs on ``device`` (default ``"cuda"``; the CPU only when asked
for). On CUDA, each labeller keeps its own stream: a dispatch enqueues the
upload, the forward, the gather and an asynchronous copy of the per-voxel
argmax into pinned host memory, then records an event, so the host can
fetch graph k (waiting on its event only) and cut it while graph k+1's
forward runs.
"""

from __future__ import annotations

import contextlib
import json
import os
import os.path as op
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from unetsulc_tpu_torch.config import _DEFAULT_MODELS, _DEFAULT_PARAMS, TpuConfig
from unetsulc_tpu_torch.data.dataset import SulciDataset
from unetsulc_tpu_torch.data.extract import extract_data
from unetsulc_tpu_torch.data.voxelize import bucket_size
from unetsulc_tpu_torch.device import resolve_device
from unetsulc_tpu_torch.io.container import read_graph
from unetsulc_tpu_torch.io.translation import FoldLabelsTranslator
from unetsulc_tpu_torch.models.interop import load_mdsm
from unetsulc_tpu_torch.models.unet3d import UNet3D
from unetsulc_tpu_torch.ops.cutting import cut_part_ids_multi, cutting
from unetsulc_tpu_torch.ops.esi import esi_score
from unetsulc_tpu_torch.train.step import make_label_fn, make_vote_fn


class SulciLabeller:
    def __init__(
        self,
        graphs: Sequence[str],
        hemi: str,
        cuda: int = -1,
        working_path: Optional[str] = None,
        dict_model: Optional[dict] = None,
        dict_names: Optional[dict] = None,
        dict_bck2: Optional[dict] = None,
        sulci_side_list: Optional[List[str]] = None,
        translation_file: Optional[str] = None,
        tpu: Optional[TpuConfig] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        dict_model = dict(dict_model or {})
        self.graphs = list(graphs)
        self.hemi = hemi
        # the `tpu` sub-dict keeps its name so parameters.json files parse;
        # compute_dtype, shape_buckets and device_vote keep their meaning
        self.tpu = tpu or TpuConfig()

        # dict_sulci / sslist (ref pattern_class.py:42-54)
        self.dict_bck2 = dict_bck2
        self.dict_names = dict_names
        self.sulci_side_list = sulci_side_list
        if sulci_side_list is not None:
            self._build_label_maps(sulci_side_list)
        else:
            self.dict_sulci = None
            self.sslist = None
        self.background = -1

        self.working_path = working_path or os.getcwd()

        # model config defaults (ref pattern_class.py:62-99)
        self.model: Optional[UNet3D] = None
        self.dict_model = dict_model
        self.model_name = dict_model.get("name", "UnknownModel_hemi" + hemi)
        self.num_filter = dict_model.get("num_filter", 64)
        self.num_channel = dict_model.get("num_channel", 1)
        self.interpolate = dict_model.get("interpolate", True)
        self.final_sigmoid = dict_model.get("final_sigmoid", False)
        self.conv_layer_order = dict_model.get("conv_layer_order", "crg")
        self.num_conv = dict_model.get("num_conv", 1)
        self.dropout = dict_model.get("dropout", 0.0)
        print("Model name: ", self.model_name)

        if translation_file is not None and os.path.exists(translation_file):
            self.flt = FoldLabelsTranslator()
            self.flt.readLabels(translation_file)
            self.trfile = translation_file
            print("Translation file loaded")
        else:
            self.flt = None
            self.trfile = None

        # results
        self.results: dict = {}
        self.dict_scores: dict = {}

        self._predict_fns: Dict = {}
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        print("Working on", torch.cuda.get_device_name(self.device)
              if self._stream is not None else self.device)

    # ------------------------------------------------------------------
    # label maps
    # ------------------------------------------------------------------
    def _build_label_maps(self, sulci_side_list: Sequence[str]) -> None:
        ssl = list(sulci_side_list)
        self.sulci_side_list = ssl
        self.dict_sulci = {name: i for i, name in enumerate(ssl)}
        if "background" not in self.dict_sulci:
            self.dict_sulci["background"] = -1
        self.sslist = [
            ss
            for ss in ssl
            if not ss.startswith("unknown") and not ss.startswith("ventricle")
        ]

    def extract_data_from_graphs(self) -> None:
        """Build sulci_side_list / dict_bck2 / dict_names from the graphs
        (ref pattern_class.py:116-139)."""
        print("Creating sulci side list...")
        names_set = set()
        dict_bck2, dict_names = {}, {}
        for gfile in self.graphs:
            graph = read_graph(gfile)
            if self.trfile is not None:
                self.flt.translate(graph)
            data = extract_data(graph)
            dict_bck2[gfile] = np.asarray(data["bck2"]).tolist()
            dict_names[gfile] = np.asarray(data["names"]).tolist()
            names_set.update(dict_names[gfile])
        self._build_label_maps(sorted(names_set))
        print(len(self.sulci_side_list), " sulci detected")
        self.dict_bck2 = dict_bck2
        self.dict_names = dict_names

    # ------------------------------------------------------------------
    # model config autofill (ref pattern_class.py:141-175)
    # ------------------------------------------------------------------
    def fill_dict_model(self, dict_model: dict) -> dict:
        dict_model = dict(dict_model)
        dict_model.setdefault("in_channels", 1)
        if "out_channels" in dict_model:
            if isinstance(dict_model["out_channels"], str):
                with open(dict_model["out_channels"], "r") as f:
                    param = json.load(f)
                dict_model["out_channels"] = len(param["sulci_side_list"])
        else:
            with open(_DEFAULT_PARAMS[self.hemi], "r") as f:
                param = json.load(f)
            dict_model["out_channels"] = len(param["sulci_side_list"])
        dict_model.setdefault("final_sigmoid", False)
        dict_model.setdefault("interpolate", True)
        dict_model.setdefault("conv_layer_order", "crg")
        if "init_channel_number" not in dict_model and "num_filter" in dict_model:
            # saved params files carry the training-side key 'num_filter'
            # (ref pattern_class.py:318-343) while the loader reads
            # 'init_channel_number' (ref :348-368)
            dict_model["init_channel_number"] = dict_model["num_filter"]
        dict_model.setdefault("init_channel_number", 64)
        dict_model.setdefault("model_file", _DEFAULT_MODELS[self.hemi])
        dict_model.setdefault("num_conv", 1)
        return dict_model

    def _make_model(self, out_channels: int, **over) -> UNet3D:
        kw = dict(
            in_channels=self.num_channel,
            out_channels=out_channels,
            final_sigmoid=self.final_sigmoid,
            interpolate=self.interpolate,
            conv_layer_order=self.conv_layer_order,
            init_channel_number=self.num_filter,
            num_conv=self.num_conv,
            dropout=self.dropout,
            compute_dtype=(
                torch.bfloat16
                if self.tpu.compute_dtype == "bfloat16"
                else torch.float32
            ),
            device=self.device,
            fused_blocks=self.tpu.pallas_blocks,
        )
        kw.update(over)
        return UNet3D(**kw)

    # ------------------------------------------------------------------
    # inference (ref pattern_class.py:247-279)
    # ------------------------------------------------------------------
    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _labeling_dispatch(
        self,
        gfile: str,
        bck2=None,
        names=None,
        imgsize=None,
    ) -> dict:
        """Voxelize and enqueue the labelling forward WITHOUT waiting for
        it: returns a handle whose device tensors may still be in flight;
        :meth:`_labeling_fetch` waits for them."""
        print("Labeling", gfile)
        if bck2 is None:
            bck2 = self.dict_bck2[gfile]
        if names is None:
            names = self.dict_names[gfile]
        bck2 = np.asarray(bck2)
        if imgsize is None and self.tpu.shape_buckets:
            # cubic shape bucket, as the JAX package (ref dataset.py:74-77
            # uses exact per-graph sizes; zero padding only adds
            # background voxels outside bck_T)
            b = bucket_size(int(np.max(bck2 - np.min(bck2, axis=0))) + 1)
            imgsize = (b, b, b)
        dataset = SulciDataset(
            [gfile],
            self.dict_sulci,
            train=False,
            translation_file=self.trfile,
            dict_bck2={gfile: bck2},
            dict_names={gfile: np.asarray(names)},
            img_size=imgsize,
        )
        vol_in, vol_lb = dataset[0]

        if "label" not in self._predict_fns:
            self._predict_fns["label"] = make_label_fn(
                self.model, final_sigmoid=self.model.final_sigmoid
            )
        label_fn = self._predict_fns["label"]

        bck_t = np.asarray(bck2 - np.min(bck2, axis=0), dtype=np.int64)
        n = len(bck_t)
        if self._stream is not None:
            # the weights were written on the current stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            ypred_d, yscores_d = label_fn(
                self._to_device(vol_in[None]), self._to_device(bck_t.T)
            )
            if self._stream is not None:
                ypred_h = torch.empty(ypred_d.shape, dtype=ypred_d.dtype,
                                      pin_memory=True)
                ypred_h.copy_(ypred_d, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                ypred_h, done = ypred_d, None
        ytrue = vol_lb[bck_t[:, 0], bck_t[:, 1], bck_t[:, 2]].tolist()
        return {
            "yscores_d": yscores_d,
            "ypred_h": ypred_h,
            "done": done,
            "n": n,
            "ytrue": ytrue,
        }

    @staticmethod
    def _fetch_ypred(handle: dict) -> np.ndarray:
        if handle["done"] is not None:
            handle["done"].synchronize()
        return handle["ypred_h"].numpy()

    def _labeling_fetch(self, handle: dict, fetch_scores: bool = True):
        """Wait for a dispatched labelling and bring its results to the
        host: (ytrue, ypred, yscores). ``fetch_scores=False`` leaves the
        (n_voxels x classes) score matrix on the device (yscores None)."""
        ypred = self._fetch_ypred(handle).tolist()
        if not fetch_scores:
            return handle["ytrue"], ypred, None
        with self._on_stream():
            yscores = handle["yscores_d"].cpu().numpy()
        return handle["ytrue"], ypred, yscores

    def labeling(
        self,
        gfile: str,
        bck2=None,
        names=None,
        imgsize=None,
    ):
        """Label one graph; returns (ytrue, ypred, yscores)."""
        return self._labeling_fetch(
            self._labeling_dispatch(gfile, bck2, names, imgsize)
        )

    def _cut_labels_device(self, handle: dict, vert, bck2, thresholds):
        """Device-voted cutting for a dispatched labelling: (T, n) per-voxel
        label ids, one row per threshold — ``cutting()``'s results without
        fetching the score matrix. The host fetches the per-voxel argmax,
        runs the geometry-only re-segmentation (``cut_part_ids_multi``),
        and the summed-score vote runs on the device
        (``train/step.py make_vote_fn``)."""
        thresholds = list(thresholds)
        parts = cut_part_ids_multi(
            self._fetch_ypred(handle), vert, bck2, thresholds
        )
        if not thresholds:
            return parts  # (0, n)
        if "vote" not in self._predict_fns:
            self._predict_fns["vote"] = make_vote_fn()
        with self._on_stream():
            votes = self._predict_fns["vote"](
                handle["yscores_d"], self._to_device(parts),
                int(parts.max()) + 1,
            ).cpu().numpy()  # (T, n_parts) per-part label ids
        return np.take_along_axis(votes, parts, axis=1)

    # ------------------------------------------------------------------
    # threshold sweep (ref pattern_class.py:177-245)
    # ------------------------------------------------------------------
    def _read_graph_data(self, gfile: str) -> dict:
        graph = read_graph(gfile)
        if self.trfile is not None:
            self.flt.translate(graph)
        return extract_data(graph)

    def test_thresholds(
        self,
        gfile_list_test: Sequence[str],
        gfile_list_notcut_test: Sequence[str],
        threshold_range: Sequence[int],
        save_results: bool = True,
    ) -> None:
        """Score every cutting threshold on the test graphs: label each
        graph, align its voxels with its uncut graph's, re-segment per
        threshold and keep (1 - ESI) * 100 per graph in
        ``dict_scores[threshold]`` (and in ``results['threshold_scores']``).

        The loop dispatches graph k+1's forward before it fetches and cuts
        graph k. With ``tpu.device_vote`` (default) the score matrix stays
        on the device (:meth:`_cut_labels_device`); ``device_vote: false``
        fetches it and cuts on the host (``ops.cutting.cutting``)."""
        print("test thresholds")
        since = time.time()
        threshold_range = list(threshold_range)
        for th in threshold_range:
            self.dict_scores[th] = []

        def finish(item) -> None:
            gfile, gfile_notcut, host, handle = item
            nbck, bck2, names, nbck_notcut, vert_notcut = host
            if len(nbck) != len(nbck_notcut):
                # alignment impossible (ref pattern_class.py:220-225)
                print()
                print("ERROR no matches between %s and %s"
                      % (gfile, gfile_notcut))
                print("--- Files ignored to fix the threshold")
                print()
                return
            # align cut <-> uncut voxels by lexicographic order of their
            # native coordinates (ref pattern_class.py:204-227)
            order_cut = np.lexsort((nbck[:, 2], nbck[:, 1], nbck[:, 0]))
            order_uncut = np.lexsort(
                (nbck_notcut[:, 2], nbck_notcut[:, 1], nbck_notcut[:, 0]))
            vert_aligned = np.empty(len(nbck), dtype=vert_notcut.dtype)
            vert_aligned[order_cut] = vert_notcut[order_uncut]
            if not threshold_range:
                return
            if self.tpu.device_vote:
                per_th_ids = self._cut_labels_device(
                    handle, vert_aligned, bck2, threshold_range)
            else:
                _, _, yscores = self._labeling_fetch(handle)
                per_th_ids = (cutting(yscores, vert_aligned, bck2, th)
                              for th in threshold_range)
            for th, ids in zip(threshold_range, per_th_ids):
                ypred_cut = [self.sulci_side_list[y] for y in ids]
                self.dict_scores[th].append(
                    (1 - esi_score(names, ypred_cut, self.sslist)) * 100)

        pending = []
        for gfile, gfile_notcut in zip(gfile_list_test, gfile_list_notcut_test):
            # dispatch first: the card works on this graph while the host
            # reads and extracts the pair below
            handle = self._labeling_dispatch(gfile)
            data = self._read_graph_data(gfile)
            data_notcut = self._read_graph_data(gfile_notcut)
            pending.append((
                gfile, gfile_notcut,
                (np.asarray(data["nbck"]), np.asarray(data["bck2"]),
                 np.asarray(data["names"]), np.asarray(data_notcut["nbck"]),
                 np.asarray(data_notcut["vert"])),
                handle,
            ))
            if len(pending) > 1:
                finish(pending.pop(0))
        for item in pending:
            finish(item)

        if save_results:
            for th, sc in self.dict_scores.items():
                self.results["threshold_scores"].setdefault(th, []).append(sc)

        elapsed = time.time() - since
        print("Cutting complete in {:.0f}m {:.0f}s".format(
            elapsed // 60, elapsed % 60))

    # ------------------------------------------------------------------
    # persistence (ref pattern_class.py:281-343)
    # ------------------------------------------------------------------
    def _label_data(self) -> dict:
        return {
            "dict_bck2": {k: np.asarray(v).tolist()
                          for k, v in self.dict_bck2.items()},
            "dict_names": {k: np.asarray(v).tolist()
                           for k, v in self.dict_names.items()},
            "sulci_side_list": self.sulci_side_list,
        }

    def _model_path(self, name: Optional[str]) -> str:
        if name is None:
            return op.join(self.working_path, "models",
                           self.model_name + "_model.mdsm")
        return op.join(self.working_path, "models", self.model_name,
                       name + "_model.mdsm")

    def save_data(self, name: Optional[str] = None) -> None:
        os.makedirs(op.join(self.working_path, "data"), exist_ok=True)
        fname = (self.model_name + ".json" if name is None
                 else name + "_data.json")
        with open(op.join(self.working_path, "data", fname), "w") as f:
            json.dump(self._label_data(), f)
        print("Data saved")

    def save_model(self, name: Optional[str] = None) -> None:
        """The model's f32 ``state_dict`` as ``.mdsm`` (``torch.save``)."""
        path = self._model_path(name)
        os.makedirs(op.dirname(path), exist_ok=True)
        torch.save({k: v.detach().to("cpu", torch.float32)
                    for k, v in self.model.state_dict().items()}, path)
        print("Model saved")

    def save_results(self, name: Optional[str] = None) -> None:
        os.makedirs(op.join(self.working_path, "results"), exist_ok=True)
        fname = (name or self.model_name) + "_results.json"
        with open(op.join(self.working_path, "results", fname), "w") as f:
            json.dump(self.results, f)
        print("Results saved")

    def save_params(self, best_threshold=None,
                    name: Optional[str] = None) -> None:
        os.makedirs(op.join(self.working_path, "models"), exist_ok=True)
        self.dict_model["model_file"] = self._model_path(name)
        self.dict_model["out_channels"] = len(self.sulci_side_list)
        params = {**self._label_data(), "dict_model": self.dict_model}
        if best_threshold is not None:
            params["cutting_threshold"] = best_threshold
        base = op.join(self.working_path, "models", self.model_name)
        if not op.exists(base):
            base = op.join(self.working_path, "models")
        fname = (name or self.model_name) + "_params.json"
        with open(op.join(base, fname), "w") as f:
            json.dump(params, f)
        print("Parameters saved")

    def reset_results(self) -> None:
        self.results = {}

    # ------------------------------------------------------------------
    # checkpoint loading (ref pattern_class.py:348-368)
    # ------------------------------------------------------------------
    def load_saved_model(self, dict_model: dict) -> None:
        dict_model = self.fill_dict_model(dict_model)
        self.model = self._make_model(
            out_channels=dict_model["out_channels"],
            in_channels=dict_model["in_channels"],
            final_sigmoid=dict_model["final_sigmoid"],
            interpolate=dict_model["interpolate"],
            conv_layer_order=dict_model["conv_layer_order"],
            init_channel_number=dict_model["init_channel_number"],
            num_conv=dict_model["num_conv"],
        )
        self.model.load_state_dict(
            load_mdsm(dict_model["model_file"]), strict=True
        )
        self.model.eval()
        self._predict_fns = {}
        print("Model Loaded !")
