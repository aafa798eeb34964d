"""Weight initialisation with the reference's schemes.

Modules are built with torch's defaults for Linear and Conv (kaiming-uniform
with a=sqrt(5), i.e. U(+-1/sqrt(fan_in)), the same as the JAX package's
`torch_kernel_init`), plus the explicit schemes below. Seed torch's RNG
(`torch.manual_seed`) before building a model for reproducible weights.
"""
from __future__ import annotations

import torch
import torch.nn as nn


def kaiming_normal_fan_out_(weight: torch.Tensor) -> torch.Tensor:
    """SE-ResNet convs (Full_model/ResNetSE34V2.py:33-38)."""
    return nn.init.kaiming_normal_(weight, mode="fan_out",
                                   nonlinearity="relu")


def xavier_reinit_all_(module: nn.Module, generator=None,
                       keep_embedding: bool = False) -> nn.Module:
    """The reference generator's constructor loop (Models_memory.py:512-514,
    the JAX package's `models/generator.py::xavier_reinit_all`): every
    parameter with ndim > 1 re-drawn xavier-uniform. The weight-norm gains
    `weight_g` are (out, 1, 1) here but 1-D in the JAX tree and in the
    reference's loop's eyes, so they are left alone."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim <= 1 or name.endswith("weight_g"):
                continue
            if keep_embedding and "embedding" in name:
                continue
            nn.init.xavier_uniform_(p, generator=generator)
    return module
