from .callbacks import (
    Callback,
    CheckpointCallback,
    CSVLogger,
    LearningRateScheduler,
    LossPrintingCallback,
    TensorBoardCallback,
)
from .checkpoint import FINAL_MARKER_OFFSET, Checkpointer
from .grouped import GroupedTrainer
from .trainer import TrainState, pad_batch, reg_row_weights

__all__ = [
    "GroupedTrainer",
    "TrainState",
    "pad_batch",
    "reg_row_weights",
    "Checkpointer",
    "FINAL_MARKER_OFFSET",
    "Callback",
    "LossPrintingCallback",
    "CSVLogger",
    "CheckpointCallback",
    "TensorBoardCallback",
    "LearningRateScheduler",
]
