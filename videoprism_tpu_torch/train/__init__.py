"""Training (port of ``videoprism_tpu.train``, so far the CLIP contrastive
train step on one device and the objectives)."""

from videoprism_tpu_torch.train import objectives
from videoprism_tpu_torch.train.train_step import (
    Optimizer,
    TrainState,
    accumulate_gradients,
    apply_updates,
    clip_loss_fn,
    create_train_state,
    make_optimizer,
    make_train_step,
    value_and_grad,
)

__all__ = [
    'Optimizer', 'TrainState', 'accumulate_gradients', 'apply_updates',
    'clip_loss_fn', 'create_train_state', 'make_optimizer', 'make_train_step',
    'objectives', 'value_and_grad',
]
