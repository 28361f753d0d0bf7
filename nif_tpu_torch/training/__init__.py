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
from .trainer import (Trainer, TrainState, make_loss_fn, make_train_step, pad_batch,
                      reg_row_weights, restore_or_init_state)

__all__ = [
    "Trainer",
    "GroupedTrainer",
    "TrainState",
    "make_train_step",
    "make_loss_fn",
    "restore_or_init_state",
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
