"""Spatial parallelism for the fused pipeline: the volume's X axis split
into slabs over a mesh of devices, one process driving every shard
(:mod:`unetsulc_tpu_torch.parallel.mesh`), with the halo plumbing of
:mod:`unetsulc_tpu_torch.parallel.sp_fused` around the halo modes of
kernels A, C and D. The counterpart of ``unetsulc_tpu/parallel/``
(``mesh.py``, ``sp_pallas.py``)."""

from unetsulc_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    shard_x,
)
from unetsulc_tpu_torch.parallel.sp_fused import sp_static_shapes_ok  # noqa: F401
