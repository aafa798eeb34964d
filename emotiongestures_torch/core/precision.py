"""Precision policy: fp32 is the parity default; bf16 is the serving mode
and the trainer's mixed precision.

As in the JAX package (emotiongestures_tpu/core/precision.py): the
generator's parameters go to bf16 while its BatchNorm running statistics
stay fp32, and the CVAE is cast whole, statistics included. In training the
fp32 parameters are the master copy: `compute_params` gives the bf16 copy a
forward and backward run on.
"""
from __future__ import annotations

import torch
import torch.nn as nn


def bf16_params_(module: nn.Module) -> nn.Module:
    """Parameters to bf16; buffers (BatchNorm statistics) stay fp32."""
    with torch.no_grad():
        for p in module.parameters():
            if p.is_floating_point():
                p.data = p.data.to(torch.bfloat16)
    return module


def cast_all_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every floating parameter and buffer to `dtype`."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.is_floating_point():
                t.data = t.data.to(dtype)
    return module


def cast_inputs(dtype: torch.dtype, *tensors):
    """Floating tensors to `dtype`; integer tensors untouched."""
    return tuple(t.to(dtype) if t.is_floating_point() else t
                 for t in tensors)


def compute_params(module: nn.Module, dtype, grads: str = "master"):
    """The parameters a mixed-precision forward runs on, for
    `torch.func.functional_call(module, params, args)`, and the tensors to
    differentiate. Buffers (BatchNorm running statistics) are not among
    them: they stay the module's own, fp32. `dtype` None keeps each
    parameter's own dtype.

      master   each parameter cast to `dtype` inside the graph, so
               gradients come back fp32 through the cast (the JAX
               package's default, emotiongestures_tpu/train/gan.py:
               236-238)
      compute  leaf copies in `dtype`: gradients come back in `dtype` and
               are upcast only at the optimizer (grad_dtype="bfloat16",
               emotiongestures_tpu/train/gan.py:232-235)
      none     detached copies in `dtype`: no gradient reaches `module`

    Returns (params, targets); `targets` follows `module.parameters()`
    order."""
    named = list(module.named_parameters())

    def cast(p):
        return p if dtype is None else p.to(dtype)

    if grads == "master":
        return {n: cast(p) for n, p in named}, [p for _, p in named]
    if grads == "compute":
        params = {n: cast(p.detach()).requires_grad_() for n, p in named}
        return params, list(params.values())
    if grads == "none":
        return {n: cast(p.detach()) for n, p in named}, []
    raise ValueError(f"unknown grads mode {grads!r}")
