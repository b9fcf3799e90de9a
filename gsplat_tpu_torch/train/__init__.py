"""Training: optimizer construction, the train step, checkpoint loading."""

from .trainer import (
    TrainState,
    batch_loss_fn,
    init_train_state,
    make_optimizer,
    make_train_step,
    position_lr,
    restore_pool,
)

__all__ = [
    "TrainState",
    "batch_loss_fn",
    "init_train_state",
    "make_optimizer",
    "make_train_step",
    "position_lr",
    "restore_pool",
]
