"""Data layer: graph -> point clouds -> dense voxel volumes (host side)."""

from unetsulc_tpu_torch.data.extract import extract_data  # noqa: F401
from unetsulc_tpu_torch.data.dataset import PatternDataset, SulciDataset  # noqa: F401
from unetsulc_tpu_torch.data.voxelize import voxelize  # noqa: F401
