from .blocks import (  # noqa: F401
    ConvolutionDownsample,
    MaskedBatchNorm,
    SparseBlock,
    SparseBlockSeries,
    SparseResidualBlock,
)
from .build import (  # noqa: F401
    SparseEventClassifier,
    build_sparse_classifier,
    init_parameters,
)
from .encoder import GRID_QUANTUM, Encoder, capacity_schedule  # noqa: F401
from .heads import MultiHeadOutput, pool_encoded  # noqa: F401
