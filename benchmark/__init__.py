"""The benchmark of the PyTorch + CUDA port (``unetsulc_tpu_torch``).

One command runs one cell once::

    python -m benchmark.run --workload <config>.<mix> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

``BENCHMARK.json`` at the repository root lists the cells and metrics;
:mod:`benchmark.registry` says where each named part lives.
"""
