"""Training: the host sampler and the train loop."""

from .loop import (
    TrainState,
    create_train_state,
    latest_checkpoint,
    load_checkpoint,
    loss_fn,
    make_train_step,
    save_checkpoint,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "latest_checkpoint",
    "load_checkpoint",
    "loss_fn",
    "make_train_step",
    "save_checkpoint",
]
