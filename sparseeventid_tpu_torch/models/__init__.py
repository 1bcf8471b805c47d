from .blocks import (  # noqa: F401
    ConvolutionDownsample,
    ConvolutionUpsample,
    InputNorm,
    MaskedBatchNorm,
    MaskedGroupNorm,
    PoolingDownsample,
    SparseBlock,
    SparseBlockSeries,
    SparseResidualBlock,
)
from .build import (  # noqa: F401
    DENSE,
    POINTS,
    SPARSE,
    PointCloudWrapper,
    SparseEventClassifier,
    build_model,
    build_sparse_classifier,
    init_parameters,
    model_family,
    require_sparse,
)
from .encoder import (  # noqa: F401
    GRID_QUANTUM,
    Encoder,
    capacity_schedule,
    encoder_output_shape,
)
from .heads import DenseChainHead, MultiHeadOutput, pool_encoded  # noqa: F401
