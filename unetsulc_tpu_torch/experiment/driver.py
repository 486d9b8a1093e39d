"""Experiment driver: cohort -> K-fold CV -> threshold vote -> artifacts
(counterpart of ``unetsulc_tpu/experiment/driver.py``; ref main.py:65-185).

Reads the cohort and the cached extracted data, builds the method, splits
the cohort as ``sklearn``'s ``KFold(n_cvinner, shuffle=True,
random_state=0)`` does (:func:`kfold_splits`, its own copy: the card's
machine has no sklearn), then per fold: learning, the threshold sweep,
the fold's model; after the last fold, the cross-fold threshold vote and
the params files. Every artifact lands under ``working_path``; the results
dict is returned.

``tpu.fold_parallel > 1`` runs the remaining folds concurrently, each in a
thread of its own on its own device group (:func:`_run_folds_parallel`),
and merges their results in fold order, so the results equal the
sequential run's on every key but the timings.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import os.path as op
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from unetsulc_tpu_torch.config import Parameters
from unetsulc_tpu_torch.method.training import TrainingSulciLabeller
from unetsulc_tpu_torch.method.transfer import TransferSulciLabeller
from unetsulc_tpu_torch.parallel.mesh import device_groups


def kfold_splits(n: int, n_splits: int,
                 seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(train, test) index arrays of ``KFold(n_splits, shuffle=True,
    random_state=seed).split(range(n))``: the indices shuffled by
    ``np.random.RandomState(seed)``, cut into contiguous test chunks of
    ``n // n_splits`` (the first ``n % n_splits`` one larger); each side
    sorted ascending."""
    if not 2 <= n_splits <= n:
        raise ValueError(f"cannot split {n} samples into {n_splits} folds")
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n, bool)
        test[idx[start:start + size]] = True
        yield np.flatnonzero(~test), np.flatnonzero(test)
        start += size


def load_cohort(params: Parameters):
    """Read the cohort JSON -> (graphs, notcut_graphs or None) (ref
    main.py:71-84)."""
    cohort_file = params.cohort_file()
    path = op.join(params.working_path, "cohorts", cohort_file + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"cohort file not found: {path}\n"
            f"Expected working_path/cohorts/{cohort_file}.json")
    with open(path, "r") as f:
        cohort = json.load(f)
    graphs, notcut_graphs = [], []
    for s in cohort["subjects"]:
        graphs.append(s["graph"])
        if notcut_graphs is not None:
            if s.get("notcut_graph") is not None:
                notcut_graphs.append(s["notcut_graph"])
            else:
                notcut_graphs = None
                print("No not cut graphs")
    print(len(graphs), "graph loaded")
    return graphs, notcut_graphs


def build_method(params: Parameters, graphs, device: Optional[str] = None):
    """The method object on ``device`` (default: the one ``params.cuda``
    names), reusing the cached extracted data if present (ref
    main.py:87-118)."""
    cohort_file = params.cohort_file()
    path_to_data = op.join(params.working_path, "data",
                           cohort_file + "_data.json")
    data = {}
    if os.path.exists(path_to_data):
        with open(path_to_data, "r") as f:
            data = json.load(f)
        print("Data Loaded")
    else:
        print("No Data Found")

    common = dict(
        working_path=params.working_path,
        dict_model=params.dict_model.to_dict(),
        translation_file=params.translation_file,
        tpu=params.tpu,
        device=device or params.device(),
    )
    if data:
        common.update(dict_names=data["dict_names"],
                      dict_bck2=data["dict_bck2"],
                      sulci_side_list=data["sulci_side_list"])
    if params.learning == "transfer_learning":
        method = TransferSulciLabeller(
            graphs, params.hemi,
            dict_trained_model=(params.dict_trained_model.to_dict()
                                if params.dict_trained_model else {}),
            **common)
    else:
        method = TrainingSulciLabeller(graphs, params.hemi, **common)

    if not data:
        method.extract_data_from_graphs()
        method.save_data(name=cohort_file)
    return method


def threshold_vote(results: dict,
                   rng: Optional[np.random.Generator] = None
                   ) -> Tuple[List[int], Optional[int]]:
    """Cross-fold best-threshold selection (ref main.py:158-185).

    Per fold, the thresholds whose mean score over the fold's graphs is
    the highest (all of them on a tie, in ``threshold_scores`` order); the
    fold's saved threshold is drawn from its ties with ``rng`` (default
    ``np.random.default_rng(0)``), folds in order. The global threshold is
    the most frequent over all folds' ties. Returns (per_fold,
    global_best), global_best None without scores."""
    rng = rng or np.random.default_rng(0)
    means = {th: [np.mean(fold) for fold in scores]
             for th, scores in results["threshold_scores"].items()}
    n_folds = max((len(m) for m in means.values()), default=0)
    ties = []
    for n in range(n_folds):
        fold = [(th, m[n]) for th, m in means.items() if len(m) > n]
        best = max(sc for _, sc in fold)
        ties.append([th for th, sc in fold if sc == best])
    per_fold = [int(rng.choice(t)) if len(t) > 1 else int(t[0]) for t in ties]
    flat = [th for t in ties for th in t]
    best_th = int(max(set(flat), key=flat.count)) if flat else None
    return per_fold, best_th


def merge_fold_results(canonical: dict, fold: dict) -> None:
    """Merge one fold's results (from a fresh per-fold method) into the
    canonical dict, in fold order, as the sequential method accumulates
    them: lists extend, ``threshold_scores`` per threshold, and the
    reference's image-size quirk (fold 0 stores a flat [x, y, z], later
    folds append lists; ref training.py:152-158)."""
    for key, val in fold.items():
        if key in ("train_image_size", "val_image_size"):
            if key not in canonical:
                canonical[key] = val
            else:
                canonical[key].append(val)
        elif key == "threshold_scores":
            tgt = canonical.setdefault(key, {})
            for th, scores in val.items():
                tgt.setdefault(th, []).extend(scores)
        elif isinstance(val, list):
            canonical.setdefault(key, []).extend(val)
        else:
            canonical[key] = val


def _run_fold(method, params: Parameters, cvi: int, glist_train,
              glist_test, glist_notcut_test, model_name: str,
              persist: bool = False) -> None:
    """CV fold ``cvi`` on ``method``: training, the cutting thresholds
    when there are not-cut graphs, the fold's model file, with ``persist``
    the method's results file (the sequential loop; a concurrent fold's
    results are saved when the driver merges them) and, with
    ``tpu.evaluate``, the fold's per-subject scores."""
    method.learning(
        lr=params.lr,
        momentum=params.momentum,
        num_epochs=params.n_epochs,
        gfile_list_train=glist_train,
        gfile_list_test=glist_test,
        batch_size=params.batch_size,
        patience=params.patience,
        save_results=True,
    )
    if glist_notcut_test is not None:
        print("\nCutting")
        method.test_thresholds(
            gfile_list_test=glist_test,
            gfile_list_notcut_test=glist_notcut_test,
            threshold_range=params.th_range,
        )
    method.save_model(name=model_name + "_cv" + str(cvi))
    if persist:
        method.save_results()  # crash-safe: persist after every fold
    if params.tpu.evaluate:
        from unetsulc_tpu_torch.experiment.evaluation import evaluate_cohort

        evaluate_cohort(method, glist_test, model_name,
                        f"{model_name}_cv{cvi}", params.cohort_file())


def _fold_worker(params: Parameters, graphs, cvi: int, glist_train,
                 glist_test, glist_notcut_test, group, model_name: str
                 ) -> dict:
    """Run CV fold ``cvi`` on its device group and return its results
    dict, which the driver merges in fold order.

    A fresh method (the extracted data re-read from the data JSON that the
    driver's method wrote) on the group's first device, with the group as
    ``devices`` (a dp or sp mesh is built from it) and ``cv_index_offset``
    set so that its tensorboard, checkpoint and model files take the true
    fold index. Concurrent folds share no mutable state and draw no global
    random numbers: each model's weights come from its own generator and
    the augmentation from per-(seed, epoch, index) generators, so a fold
    computes what it computes in the sequential loop. The thread's current
    card is the group's, as ``jax.default_device`` pins the JAX worker."""
    home = group[0]
    method = build_method(params, graphs, home)
    method.devices = tuple(group)
    method.cv_index_offset = cvi
    with (torch.cuda.device(home) if home.type == "cuda"
          else contextlib.nullcontext()):
        _run_fold(method, params, cvi, glist_train, glist_test,
                  glist_notcut_test, model_name)
    return method.results


def _run_folds_parallel(params: Parameters, method, folds, graphs,
                        notcut_agraphs, completed_folds: int, model_name: str,
                        groups) -> None:
    """Run the remaining CV ``folds`` concurrently, fold ``cvi`` on group
    ``(cvi - completed_folds) % len(groups)``, in ``len(groups)`` threads
    (the reference's fold loop shares nothing between folds: a fresh model
    and optimizer each, results only appended). The results merge into
    ``method.results`` in fold order, saved after each merge, with the
    group layout under ``fold_parallel``."""
    from concurrent.futures import ThreadPoolExecutor

    names = [[str(d) for d in g] for g in groups]
    print(f"fold_parallel={len(groups)}: running folds concurrently on "
          f"device groups {names}")
    layout = {"n_groups": len(groups), "groups": names, "folds": {}}
    agraphs = np.asarray(graphs)
    futures = {}
    with ThreadPoolExecutor(max_workers=len(groups)) as ex:
        for cvi, (train, test) in folds:
            gi = (cvi - completed_folds) % len(groups)
            layout["folds"][str(cvi)] = gi
            futures[cvi] = ex.submit(
                _fold_worker, params, graphs, cvi, list(agraphs[train]),
                list(agraphs[test]),
                (list(notcut_agraphs[test]) if notcut_agraphs is not None
                 else None),
                groups[gi], model_name)
        for cvi in sorted(futures):
            merge_fold_results(method.results, futures[cvi].result())
            method.results["fold_parallel"] = layout
            method.save_results()  # crash-safe per in-order fold


def _fold_groups(params: Parameters, device: torch.device, devices):
    """The device groups of ``tpu.fold_parallel``: ``devices`` when given,
    else every visible card, or on the CPU as many CPU entries as the
    groups' meshes take."""
    n = params.tpu.fold_parallel
    if devices is None and device.type == "cpu":
        per = max(1, params.tpu.data_parallel) * params.tpu.spatial_parallel
        devices = [device] * (n * per)
    return device_groups(n, devices)


def run_experiment(params: Parameters, device: Optional[str] = None,
                   devices=None):
    """Full CV run (the reference's ``__main__`` block, ref
    main.py:65-185) on ``device`` (default: the one ``params.cuda``
    names). With ``tpu.fold_parallel > 1`` the folds run on device groups
    cut from ``devices`` (default: every visible card, or the CPU when
    ``device`` is the CPU); a list may repeat one card."""
    print("working directory: ", params.working_path)
    print("cohort: ", params.cohort_name)
    print("hemi: ", params.hemi)

    graphs, notcut_graphs = load_cohort(params)
    method = build_method(params, graphs, device)
    model_name = params.dict_model.name

    print("\n----- Learning -----\n")
    start_time = time.time()
    agraphs = np.asarray(graphs)
    notcut_agraphs = (np.asarray(notcut_graphs)
                      if notcut_graphs is not None else None)

    # fold-level resume (no reference counterpart: the reference writes
    # results only at the end, ref main.py:147)
    completed_folds = 0
    results_path = op.join(params.working_path, "results",
                           model_name + "_results.json")
    if params.tpu.resume and os.path.exists(results_path):
        with open(results_path, "r") as f:
            prior = json.load(f)
        if prior.get("lr"):
            # JSON stringifies the threshold keys; restore ints so that
            # test_thresholds appends to the same buckets
            prior["threshold_scores"] = {
                (int(k) if str(k).lstrip("-").isdigit() else k): v
                for k, v in prior.get("threshold_scores", {}).items()
            }
            method.results = prior
            completed_folds = len(prior["lr"])
            print(f"Resuming: {completed_folds} fold(s) already complete")

    fold_par = params.tpu.fold_parallel
    if fold_par > 1 and params.learning == "transfer_learning":
        # transfer folds carry state across folds: the fine-tuning
        # unfreeze extends the method's training_layers for the folds
        # after it (the reference's method reused across folds), which
        # fresh concurrent methods would silently drop
        print("fold_parallel: transfer_learning folds carry state across "
              "folds (fine-tuning unfreeze extends training_layers for "
              "subsequent folds, reference semantics) — running folds "
              "sequentially")
        fold_par = 1
    if fold_par > 1:
        remaining = [(cvi, split) for cvi, split in enumerate(
            kfold_splits(len(graphs), params.n_cvinner))
            if cvi >= completed_folds]
        _run_folds_parallel(params, method, remaining, graphs, notcut_agraphs,
                            completed_folds, model_name,
                            _fold_groups(params, method.device, devices))

    for cvi, (train, test) in enumerate(
            kfold_splits(len(graphs), params.n_cvinner)):
        if cvi < completed_folds or fold_par > 1:
            continue
        print("\n== Cross Validation {}/{} ==\n".format(
            cvi, params.n_cvinner - 1))
        _run_fold(method, params, cvi, agraphs[train], agraphs[test],
                  (notcut_agraphs[test] if notcut_agraphs is not None
                   else None), model_name, persist=True)

    method.save_results()
    cv_time = time.time() - start_time
    print("Cross Validation complete in {:.0f}h {:.0f}m {:.0f}s".format(
        cv_time // 3600, (cv_time % 3600) // 60, (cv_time % 3600) % 60))

    with open(results_path, "r") as f:
        results = json.load(f)

    print("\nFinal Results")
    print("Mean accuracy: ", np.mean(results["best_acc"]))

    if notcut_agraphs is not None:
        per_fold, best_th = threshold_vote(results)
        for n, th in enumerate(per_fold):
            print("Training n°", n, " | Best threshold:", th)
            method.save_params(best_threshold=int(th),
                               name=model_name + "_cv" + str(n))
        method.save_params(best_threshold=best_th)
        print("\nBest Threshold: ", best_th)
    return results


def run_both_hemispheres(params: Parameters, device: Optional[str] = None):
    """The full L + R study as one call: each hemisphere an independent
    experiment (own cohort file, model and artifacts); the reference runs
    one hemisphere per invocation."""
    results = {}
    for hemi in ("L", "R"):
        p = copy.deepcopy(params)
        p.hemi = hemi
        if not p.dict_model.name.endswith(f"_hemi{hemi}"):
            p.dict_model.name = f"{p.dict_model.name}_hemi{hemi}"
        results[hemi] = run_experiment(p, device)
    return results
