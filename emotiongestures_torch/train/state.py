"""Train state (port of emotiongestures_tpu/train/state.py): a module, its
optimizer and the update count.

The JAX state carries params, batch_stats and opt_state as values and
returns a new state per update. Here the module holds the parameters and,
in its buffers, the BatchNorm running statistics; the optimizer holds
Adam's moments; `apply_gradients` updates all of them in place and advances
`step`.
"""
from __future__ import annotations

import contextlib
import itertools
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch
import torch.nn as nn


@dataclass
class TrainState:
    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # update count -> lr, evaluated before the count advances (optax's
    # scale_by_learning_rate); None keeps the optimizer's lr
    lr_schedule: Optional[Callable[[int], float]] = None
    # > 0: optax's clip_by_global_norm on the raw gradients, before the
    # optimizer's coupled L2
    grad_clip: float = 0.0

    def __post_init__(self):
        if self.grad_clip < 0:
            raise ValueError(f"grad_clip must be >= 0 (0 disables), got "
                             f"{self.grad_clip}")

    def apply_gradients(self, grads: Iterable[Optional[torch.Tensor]]):
        """One optimizer update. `grads` follows `module.parameters()`; a
        None is a zero gradient, as JAX gives a parameter the loss does not
        reach (Adam still moves it by its moments). Gradients of another
        dtype (bf16 under grad_dtype="bfloat16") are upcast here."""
        params = list(self.module.parameters())
        grads = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                 for p, g in zip(params, grads)]
        if self.grad_clip > 0:
            grads = clip_by_global_norm(grads, self.grad_clip)
        for p, g in zip(params, grads):
            p.grad = g
        if self.lr_schedule is not None:
            lr = self.lr_schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self

    def minimize(self, loss: torch.Tensor):
        """One update on the gradient of `loss` with respect to the
        module's parameters."""
        return self.apply_gradients(torch.autograd.grad(
            loss, list(self.module.parameters()), allow_unused=True))


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """`module` in eval mode, with no autograd, for the duration; its mode
    before is put back."""
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            yield module
    finally:
        module.train(was_training)


def finite_check(obj) -> bool:
    """NaN/inf guard over a TrainState's or a module's parameters and
    buffers, or over an iterable of tensors: one device sync."""
    if isinstance(obj, TrainState):
        obj = obj.module
    if isinstance(obj, nn.Module):
        obj = itertools.chain(obj.parameters(), obj.buffers())
    flags = [torch.isfinite(t).all() for t in obj if t.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax.clip_by_global_norm: with n the l2 norm of all of `grads`
    together, each g becomes g / n * max_norm when n >= max_norm and stays
    as it is otherwise. No epsilon (torch.nn.utils.clip_grad_norm_ divides
    by n + 1e-6). No host sync: the choice is a torch.where."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]
