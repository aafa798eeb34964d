"""Train state (port of emotiongestures_tpu/train/state.py): a module, its
optimizer and the update count.

The JAX state carries params, batch_stats and opt_state as values and
returns a new state per update. Here the module holds the parameters and,
in its buffers, the BatchNorm running statistics; the optimizer holds
Adam's moments; `apply_gradients` updates all of them in place and advances
`step`.

Under data parallelism (parallel/mesh.py) `apply_gradients` first takes the
mean of the gradients over the ranks, one all-reduce per dtype, so the
global norm that clipping reads and the update are the same on every rank:
the step of one process on the global batch. Modules are not wrapped in
DistributedDataParallel, which does not work with `torch.autograd.grad`.
Gradients are reduced after the upcast to the parameters' fp32: under
grad_dtype="bfloat16" each rank's bf16 gradient of its rows is summed in
fp32, where one process rounds the global batch's gradient to bf16 once,
so the two differ by the bf16 rounding of the partial sums.

Under tensor parallelism (parallel/tensor.py) the mean runs over the data
group only, each shard's gradient beside its shard; Adam updates the
shards and their moments; the global norm of `grad_clip` sums each sharded
gradient's squares over the model group once and counts each replicated
one once (optax's clip_by_global_norm over the whole tree).
"""
from __future__ import annotations

import contextlib
import itertools
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch
import torch.nn as nn

from ..parallel import mesh, tensor


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
        dtype (bf16 under grad_dtype="bfloat16") are upcast here, then
        averaged over the data-parallel ranks."""
        params = list(self.module.parameters())
        grads = mesh.all_reduce_mean(
            [torch.zeros_like(p) if g is None else g.to(p.dtype)
             for p, g in zip(params, grads)])
        if self.grad_clip > 0:
            grads = clip_by_global_norm(grads, self.grad_clip,
                                        tensor.sharded_flags(self.module))
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


def clip_by_global_norm(grads: list, max_norm: float,
                        sharded=None) -> list:
    """optax.clip_by_global_norm: with n the l2 norm of all of `grads`
    together, each g becomes g / n * max_norm when n >= max_norm and stays
    as it is otherwise. No epsilon (torch.nn.utils.clip_grad_norm_ divides
    by n + 1e-6). No host sync: the choice is a torch.where. `sharded`
    marks the gradients that are this rank's shards of the model group's
    tensors: their squares are summed over the group."""
    norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
    if sharded is None or not any(sharded):
        norm = torch.linalg.vector_norm(norms)
    else:
        split = torch.tensor(sharded, device=norms.device)
        sq = norms.square()
        whole = mesh.model_sum(torch.where(split, sq, 0).sum())
        norm = torch.sqrt(whole + torch.where(split, 0, sq).sum())
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]
