"""Skeleton emotion classifier training (port of
emotiongestures_tpu/train/skeleton.py; the reference ships no trainer for
skeleton_classifer/Models.py): cross-entropy on pose windows. The eval
freezes it for Emotion-Acc (test_...py:217-221).

The JAX module's docstrings give the recipe's reasons, which hold here:
no weight decay by default, a linear LR warmup (the post-LN d_model-512
classifier does not leave chance without one), global-norm clipping for
ambiguous data, and the `PlateauDetector` that reseeds a run stuck at
chance (the architecture's init lottery). Unlike `if grad_clip:` in the
JAX package, a negative clip is refused (`TrainState` raises ValueError)
rather than applied, which would flip every update.
"""
from __future__ import annotations

from collections import deque

import torch

from ..core import losses, schedules
from ..core.layers import dropout_generator
from ..models.skeleton_classifier import SkeletonTransformer
from ..parallel import mesh
from .gan import step_key
from .state import TrainState, eval_mode


def create_state(seed: int = 0, lr: float = 3e-4, pose_dim: int = 282,
                 d_model: int = 512, d_inner: int = 2048,
                 weight_decay: float = 0.0, warmup_steps: int = 0,
                 grad_clip: float = 0.0, n_position: int = 60,
                 device=None) -> TrainState:
    """Adam(lr, betas (0.5, 0.999), coupled `weight_decay`); with
    `warmup_steps`, optax's linear_schedule(0, lr, warmup_steps) on the
    update count; with `grad_clip` > 0, optax's clip_by_global_norm on the
    raw gradients. Weights drawn from torch's generator seeded with
    `seed`."""
    torch.manual_seed(seed)
    model = SkeletonTransformer(pose_dim=pose_dim, d_model=d_model,
                                d_inner=d_inner, n_position=n_position,
                                device=device)
    opt = schedules.adam(model.parameters(), lr=lr, b1=0.5, b2=0.999,
                         weight_decay=weight_decay)
    schedule = (schedules.linear_warmup(lr, warmup_steps)
                if warmup_steps else None)
    return TrainState(model, opt, lr_schedule=schedule, grad_clip=grad_clip)


def train_step(state: TrainState, poses: torch.Tensor,
               labels_onehot: torch.Tensor, rng: int):
    """One update, in place. Returns the state and 0-d tensors {"loss",
    "acc"} (accuracy in %)."""
    labels = labels_onehot.argmax(dim=1)
    model = state.module.train()
    gen = torch.Generator(device=poses.device).manual_seed(rng)
    with dropout_generator(model, gen):
        logits, _ = model(poses)
    loss = losses.cross_entropy(logits, labels).mean()
    state.minimize(loss)
    acc = 100.0 * (logits.detach().argmax(dim=1) == labels).float().mean()
    return state, mesh.mean_metrics({"loss": loss.detach(), "acc": acc})


def predict(state: TrainState, poses: torch.Tensor):
    """Eval-mode (logits, mid_feature)."""
    with eval_mode(state.module) as model:
        return model(poses)


class PlateauDetector:
    """Auto-reseed for the reference architecture's init lottery (the JAX
    package's PlateauDetector, same criterion and latch): if the mean
    training accuracy over the trailing `window` steps has not reached
    `acc_target` % within `patience` steps of the last (re)start, a reseed
    is due, and is checked again every step after; at most `max_reseeds`.
    Once the trailing mean has reached the target the detector latches
    converged and never reseeds again.

        det = PlateauDetector()
        ...
        if det.update(float(metrics["acc"])):
            state = create_state(det.next_key(seed), ...)
    """

    def __init__(self, patience: int = 800, acc_target: float = 40.0,
                 max_reseeds: int = 8, window: int = 50):
        self.patience = patience
        self.acc_target = acc_target
        self.max_reseeds = max_reseeds
        self.window = window
        self.attempts = 0
        self._steps = 0
        self._converged = False
        self._recent: deque[float] = deque(maxlen=window)

    def update(self, acc: float) -> bool:
        """Record one step's training accuracy; True: reseed now."""
        if self._converged:
            return False
        self._steps += 1
        self._recent.append(acc)
        if (sum(self._recent) / len(self._recent)) >= self.acc_target:
            self._converged = True
            return False
        if self._steps >= self.patience and self.attempts < self.max_reseeds:
            self.attempts += 1
            self._steps = 0
            self._recent.clear()
            return True
        return False

    def next_key(self, base_seed: int) -> int:
        """The init seed of the current attempt, from (base_seed, 104729 +
        attempts), as the JAX package folds 104729 + attempts into its base
        key."""
        return step_key(base_seed, 104729 + self.attempts)
