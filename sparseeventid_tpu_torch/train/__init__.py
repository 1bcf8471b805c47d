from .losses import (  # noqa: F401
    focal_loss,
    multi_head_accuracy,
    multi_head_loss,
    smoothed_cross_entropy,
)
from .supervised import eval_metrics, make_eval_step, make_predict_step  # noqa: F401
