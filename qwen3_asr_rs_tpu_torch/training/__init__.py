"""Fine-tuning: the training step, the corpus pipeline and checkpoints."""

from .checkpoint import (
    AsyncTrainCheckpointer,
    restore_train_state,
    save_train_state,
)
from .data import (
    AsrDataset,
    Utterance,
    dp_rows,
    prefetch_to_device,
    read_manifest,
)
from .train_step import TrainState, adamw, asr_loss, make_train_step, sgd

__all__ = [
    "AsrDataset",
    "AsyncTrainCheckpointer",
    "TrainState",
    "Utterance",
    "adamw",
    "asr_loss",
    "dp_rows",
    "make_train_step",
    "prefetch_to_device",
    "read_manifest",
    "restore_train_state",
    "save_train_state",
    "sgd",
]
