"""Train state (port of emotiongestures_tpu/train/state.py): a module, its
optimizer and the update count.

The JAX state carries params, batch_stats and opt_state as values and
returns a new state per update. Here the module holds the parameters and,
in its buffers, the BatchNorm running statistics; the optimizer holds
Adam's moments; `apply_gradients` updates all of them in place and advances
`step`.
"""
from __future__ import annotations

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

    def apply_gradients(self, grads: Iterable[Optional[torch.Tensor]]):
        """One optimizer update. `grads` follows `module.parameters()`; a
        None is a zero gradient, as JAX gives a parameter the loss does not
        reach (Adam still moves it by its moments). Gradients of another
        dtype (bf16 under grad_dtype="bfloat16") are upcast here."""
        for p, g in zip(self.module.parameters(), grads):
            p.grad = torch.zeros_like(p) if g is None else g.to(p.dtype)
        if self.lr_schedule is not None:
            lr = self.lr_schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self


def finite_check(obj) -> bool:
    """NaN/inf guard over a TrainState's or a module's parameters and
    buffers, or over an iterable of tensors: one device sync."""
    if isinstance(obj, TrainState):
        obj = obj.module
    if isinstance(obj, nn.Module):
        obj = itertools.chain(obj.parameters(), obj.buffers())
    flags = [torch.isfinite(t).all() for t in obj if t.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True
