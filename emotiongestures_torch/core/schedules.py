"""Optimizers and LR schedules of the reference (port of
emotiongestures_tpu/core/schedules.py).

  * Adam(lr, betas=(0.5, 0.999), weight_decay) with *coupled* L2: torch's
    Adam adds weight_decay * param to the gradient before the moments, which
    is optax's add_decayed_weights followed by scale_by_adam
    (train_audio_classifier_K_fold.py:132)
  * the staged LR ladder (adjust_lr, test_emotion_gesture_diversity_
    iterative.py:64-78), per epoch and per update
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch


def staged_lr(init_lr: float) -> Callable[[int], float]:
    """The reference's epoch-indexed ladder: epochs <= 15 1x, 16-50 0.2x,
    51-80 0.01x, 81-100 0.005x, later 0.001x."""

    def lr_for_epoch(epoch: int) -> float:
        if epoch <= 15:
            scale = 1.0
        elif epoch <= 50:
            scale = 0.2
        elif epoch <= 80:
            scale = 0.01
        elif epoch <= 100:
            scale = 0.005
        else:
            scale = 0.001
        return init_lr * scale

    return lr_for_epoch


def staged_step_lr(init_lr: float,
                   steps_per_epoch: int) -> Callable[[int], float]:
    """The ladder as a function of the update count. optax evaluates a
    schedule at the count before it is incremented, so update t (from 0)
    runs at ladder(t // steps_per_epoch)."""
    ladder = staged_lr(init_lr)
    return lambda count: ladder(count // max(steps_per_epoch, 1))


def adam(params: Iterable[torch.nn.Parameter], lr: float = 3e-4,
         b1: float = 0.5, b2: float = 0.999, weight_decay: float = 1e-5,
         eps: float = 1e-8) -> torch.optim.Adam:
    """torch.optim.Adam with the reference's betas and coupled L2. A
    schedule is applied by the train state (`train/state.py`), which sets
    each update's lr from its count."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)
