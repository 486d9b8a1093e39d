"""unetsulc_tpu_torch — the PyTorch + CUDA port of ``unetsulc_tpu``.

A second package beside the JAX one, for an NVIDIA H100 (Hopper, sm_90a).
It mirrors the JAX package's module names so each counterpart is easy to
find, imports nothing of it (it keeps its own copies of the jax-free host
modules), and is tested against it on the CPU.

It runs both CLIs of the JAX package on the card: labelling
(``python -m unetsulc_tpu_torch.label``) and the cross-validated training
experiment (``python -m unetsulc_tpu_torch.main -p parameters.json``), on
the flagship UNet3D's fused pipeline (hand-written CUDA kernels,
:mod:`unetsulc_tpu_torch.kernels`) or its non-fused path, on one device or
spatially sharded (each encoder and decoder recomputed in the backward
with ``remat``); the pattern classifier
(:mod:`unetsulc_tpu_torch.models.pattern_cnn` on
:class:`~unetsulc_tpu_torch.data.dataset.PatternDataset`); the matrix-unit
probe (``python -m unetsulc_tpu_torch.tools.mxu_probe``), the cohort tools
and the ``.arg`` -> ``.npz`` converter (:mod:`unetsulc_tpu_torch.tools`),
the ``.arg`` writer and the analysis figures
(:mod:`unetsulc_tpu_torch.figures`).

Every entry point takes a ``device`` argument that defaults to ``"cuda"``
and raises when CUDA is absent; the CPU runs only when asked for
(``device="cpu"``), through each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

from unetsulc_tpu_torch.config import Parameters  # noqa: F401


def __getattr__(name):
    """Lazy top-level API (keeps ``import unetsulc_tpu_torch`` light): the
    JAX package's table, each name from the port's module of that name."""
    lazy = {
        "UNet3D": ("unetsulc_tpu_torch.models.unet3d", "UNet3D"),
        "SulciDataset": ("unetsulc_tpu_torch.data.dataset", "SulciDataset"),
        "PatternDataset": ("unetsulc_tpu_torch.data.dataset",
                           "PatternDataset"),
        "SulciLabeller": ("unetsulc_tpu_torch.method.base", "SulciLabeller"),
        "TrainingSulciLabeller": ("unetsulc_tpu_torch.method.training",
                                  "TrainingSulciLabeller"),
        "TransferSulciLabeller": ("unetsulc_tpu_torch.method.transfer",
                                  "TransferSulciLabeller"),
        "run_experiment": ("unetsulc_tpu_torch.experiment.driver",
                           "run_experiment"),
        "read_graph": ("unetsulc_tpu_torch.io.container", "read_graph"),
        "extract_data": ("unetsulc_tpu_torch.data.extract", "extract_data"),
        "esi_score": ("unetsulc_tpu_torch.ops.esi", "esi_score"),
        "cutting": ("unetsulc_tpu_torch.ops.cutting", "cutting"),
    }
    if name in lazy:
        import importlib

        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(name)
