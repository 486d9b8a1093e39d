"""CLI: train a sulci-labelling model from a parameters.json, on the GPU.

The port's counterpart of the repository's ``main.py`` (ref main.py:24-44):

    python -m unetsulc_tpu_torch.main -p parameters.json [--device cpu]

reads the same ``parameters.json`` and writes the same artifact tree under
``working_path``: ``data/cohort-*_data.json``, ``models/<name>/
<name>_cv{i}_model.mdsm`` and ``_params.json``, ``models/<name>/
<name>_params.json`` with ``cutting_threshold``, ``results/
<name>_results.json`` and ``tensorboard/<name>/cv{i}/``.

The device is the file's ``cuda`` (-1 the CPU, N ``cuda:N``, absent the
card); ``--device`` overrides it. Without CUDA, anything but the CPU
raises: nothing falls back.
"""

from __future__ import annotations

import argparse
import os
import warnings
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    # the reference filters this labelling-time warning (ref main.py:21)
    warnings.filterwarnings(action="ignore", message="the number of",
                            category=UserWarning)
    parser = argparse.ArgumentParser(description="Train UNET model")
    parser.add_argument("-p", dest="parameters", type=str, default=None,
                        help="Parameter file (default: parameters.json in "
                             "the working directory)")
    parser.add_argument("--device", default=None,
                        help="torch device, overriding the file's 'cuda' "
                             "(e.g. cpu, cuda, cuda:1)")
    args = parser.parse_args(argv)
    path = args.parameters or os.path.join(os.getcwd(), "parameters.json")

    from unetsulc_tpu_torch.config import Parameters
    from unetsulc_tpu_torch.experiment.driver import run_experiment

    params = Parameters.from_file(path)
    return run_experiment(params, device=args.device)


if __name__ == "__main__":
    main()
