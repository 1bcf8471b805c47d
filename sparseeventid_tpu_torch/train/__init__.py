from .losses import (  # noqa: F401
    focal_loss,
    multi_head_accuracy,
    multi_head_loss,
    smoothed_cross_entropy,
)
from .optimizers import build_optimizer  # noqa: F401
from .schedules import build_lr_schedule  # noqa: F401
from .state import TrainState, param_count  # noqa: F401
from .supervised import (  # noqa: F401
    eval_metrics,
    make_eval_step,
    make_predict_step,
    make_train_step,
)
