from .conv import (  # noqa: F401
    apply_conv,
    average_pool,
    deconv,
    gather_neighbors,
    strided_conv,
    submanifold_conv,
)
from .norm import apply_norm, masked_batch_stats, masked_group_norm  # noqa: F401
from .pool import global_avg_pool, global_max_pool  # noqa: F401
from .rulebook import (  # noqa: F401
    Rulebook,
    build_downsample_rulebook,
    build_submanifold_rulebook,
    build_upsample,
    downsample_sites,
    kernel_offsets,
)
from .sparse_tensor import (  # noqa: F401
    INVALID_KEY,
    SparseTensor,
    build_sparse_tensor,
    from_dense,
    linearize,
    to_dense,
    unlinearize,
)
