"""Data and spatial parallelism: a (data, space) mesh of devices, one
process driving every shard (:mod:`unetsulc_tpu_torch.parallel.mesh`):
the batch cut over the data rows, and for the fused pipeline the volume's
X axis split into slabs along a row, with the halo plumbing of
:mod:`unetsulc_tpu_torch.parallel.sp_fused` around the halo modes of
kernels A, C and D. The counterpart of ``unetsulc_tpu/parallel/``
(``mesh.py``, ``sp_pallas.py``)."""

from unetsulc_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    device_groups,
    make_mesh,
    shard_batch,
    shard_x,
)
from unetsulc_tpu_torch.parallel.sp_fused import sp_static_shapes_ok  # noqa: F401
