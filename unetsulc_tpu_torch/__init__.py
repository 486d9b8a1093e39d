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
spatially sharded; and the matrix-unit probe
(``python -m unetsulc_tpu_torch.tools.mxu_probe``).

Every entry point takes a ``device`` argument that defaults to ``"cuda"``
and raises when CUDA is absent; the CPU runs only when asked for
(``device="cpu"``), through each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
