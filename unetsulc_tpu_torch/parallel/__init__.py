"""Data and spatial parallelism: a (data, space) mesh of devices, one
process driving every shard (:mod:`unetsulc_tpu_torch.parallel.mesh`):
the batch cut over the data rows, and the volume's X axis split into slabs
along a row. The fused pipeline runs its slabs through the halo modes of
kernels A, C and D with the plumbing of
:mod:`unetsulc_tpu_torch.parallel.sp_fused`; the non-fused path through
the sharded ops of :mod:`unetsulc_tpu_torch.parallel.halo` (explicit
halo exchange, uneven deep levels). The counterpart of
``unetsulc_tpu/parallel/`` (``mesh.py``, ``sp_pallas.py``, ``halo.py``)."""

from unetsulc_tpu_torch.parallel.halo import (  # noqa: F401
    conv3d_spatial,
    dropout_spatial,
    gather_rows,
    level_rows,
    max_pool_3d_spatial,
    resize_trilinear_spatial,
    row_ranges,
    upsample_transpose_spatial,
)
from unetsulc_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    device_groups,
    make_mesh,
    shard_batch,
    shard_x,
)
from unetsulc_tpu_torch.parallel.sp_fused import sp_static_shapes_ok  # noqa: F401
