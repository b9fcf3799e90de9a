"""Training: optimizer construction, the train step, the ADC steps,
checkpoints and ``fit()``."""

from .fit import FitReport, fit
from .trainer import (
    TrainState,
    adc_step,
    adc_step_paper,
    batch_loss_fn,
    grow_state_capacity,
    init_train_state,
    load_checkpoint,
    load_checkpoint_dcp,
    make_optimizer,
    make_train_step,
    opacity_raise_step,
    position_lr,
    reset_opt_state_slots,
    restore_pool,
    save_checkpoint,
    save_checkpoint_dcp,
)

__all__ = [
    "FitReport",
    "TrainState",
    "adc_step",
    "adc_step_paper",
    "batch_loss_fn",
    "fit",
    "grow_state_capacity",
    "init_train_state",
    "load_checkpoint",
    "load_checkpoint_dcp",
    "make_optimizer",
    "make_train_step",
    "opacity_raise_step",
    "position_lr",
    "reset_opt_state_slots",
    "restore_pool",
    "save_checkpoint",
    "save_checkpoint_dcp",
]
