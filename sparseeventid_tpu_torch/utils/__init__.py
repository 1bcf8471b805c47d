from .checkpoint import (  # noqa: F401
    CheckpointManager,
    encoder_freeze_names,
    load_encoder_only,
)
from .logger import process_log  # noqa: F401
from .telemetry import StepTimer, SummaryWriter, format_log_message  # noqa: F401
