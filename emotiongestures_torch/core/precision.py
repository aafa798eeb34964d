"""Precision policy: fp32 is the parity default; bf16 is the serving mode.

As in the JAX package (emotiongestures_tpu/core/precision.py): the
generator's parameters go to bf16 while its BatchNorm running statistics
stay fp32, and the CVAE is cast whole, statistics included.
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
