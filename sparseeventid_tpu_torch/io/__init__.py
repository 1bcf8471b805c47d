from .synthetic import SyntheticDataset, SyntheticEventConfig, generate_event  # noqa: F401
from .transforms import larcv_batch_to_sparse_3d  # noqa: F401
