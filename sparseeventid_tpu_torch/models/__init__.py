from .blocks import (  # noqa: F401
    ConvolutionDownsample,
    ConvolutionUpsample,
    MaskedBatchNorm,
    PoolingDownsample,
    SparseBlock,
    SparseBlockSeries,
    SparseResidualBlock,
)
from .build import (  # noqa: F401
    SparseEventClassifier,
    build_sparse_classifier,
    init_parameters,
    model_family,
)
from .encoder import (  # noqa: F401
    GRID_QUANTUM,
    Encoder,
    capacity_schedule,
    encoder_output_shape,
)
from .heads import MultiHeadOutput, pool_encoded  # noqa: F401
