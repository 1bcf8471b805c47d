from .dataset import BatchLoader  # noqa: F401
from .synthetic import SyntheticDataset, SyntheticEventConfig, generate_event  # noqa: F401
from .transforms import (  # noqa: F401
    larcv_batch_to_dense,
    larcv_batch_to_pointcloud,
    larcv_batch_to_sparse_2d,
    larcv_batch_to_sparse_3d,
)
