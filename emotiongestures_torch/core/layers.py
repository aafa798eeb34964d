"""Layers with the JAX package's dtype rules, in torch.nn.Module form.

The JAX package (emotiongestures_tpu/core/layers.py and flax) lets types
promote: a Linear computes in its input's type (the kernel is cast to it), a
convolution in the promoted type of input and kernel, a BatchNorm in at least
fp32 with its output in the promoted type of input, scale and bias. PyTorch
raises on mixed-type products instead of promoting, so each of these casts is
written out here. Under bf16 serving that makes, for example, the generator's
fusion MLP and transformer compute in fp32 with bf16 weights, as in JAX.

Attribute names are the reference PyTorch ones (`weight`, `bias`,
`running_mean`, `running_var`), so state_dicts load with strict=True.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def promoted(*tensors) -> torch.dtype:
    """jnp.result_type of the tensors' dtypes (same lattice as torch's for
    fp32/bf16/fp16)."""
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors))


class Linear(nn.Linear):
    """y = x W^T + b computed in x's dtype (JAX Linear casts the kernel)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv1d(nn.Conv1d):
    """Convolution in the promoted dtype of input, kernel and bias."""

    def forward(self, x):
        dt = promoted(x, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        dt = promoted(x, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), b)


class ConvTranspose1d(nn.ConvTranspose1d):
    def forward(self, x):
        dt = promoted(x, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose1d(x.to(dt), self.weight.to(dt), b,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1 with torch's eps 1e-5, flax's dtype
    rule: mul = rsqrt(var + eps) * scale in the stats' and scale's type, the
    normalisation in fp32, the output in the promoted type of x, scale and
    bias. Holds no `num_batches_tracked`: the JAX tree has none.

    Written as one fused pass y = x * mul + (bias - mean * mul), in fp32."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "BatchNorm: the port serves in eval mode; training comes "
                "with the trainers")
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        mul = mul.float()
        shift = self.bias.float() - self.running_mean.float() * mul
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = torch.addcmul(shift.view(shape), x, mul.view(shape))
        return y.to(promoted(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm: statistics in fp32, output in the promoted type of
    x, scale and bias."""

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 * x32).mean(-1, keepdim=True) - mean * mean
        mul = torch.rsqrt(var.clamp(min=0) + self.eps) * self.weight
        y = (x32 - mean) * mul + self.bias
        return y.to(promoted(x, self.weight, self.bias))


@functools.lru_cache(maxsize=8)
def _sinusoid_np(n_position: int, d_hid: int) -> np.ndarray:
    pos = np.arange(n_position)[:, None].astype(np.float64)
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def sinusoid_position_table(n_position: int, d_hid: int) -> torch.Tensor:
    """angle[pos, j] = pos / 10000^(2*(j//2)/d): sin on even j, cos on odd,
    built in float64 and cast to fp32."""
    return torch.from_numpy(_sinusoid_np(n_position, d_hid))
