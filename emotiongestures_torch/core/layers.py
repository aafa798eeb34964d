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

Train mode follows flax, not torch. BatchNorm normalises with the batch's
*biased* variance E[x^2] - E[x]^2 taken in fp32, and writes running =
0.9 * running + 0.1 * batch with that same biased variance (torch's
`F.batch_norm` would write the unbiased one); `frozen_stats` runs a
batch-statistics forward that writes nothing. Dropout keeps with
probability 1 - p, scales the kept values by 1 / (1 - p) and draws its mask
from the generator that `dropout_generator` hands it.
"""
from __future__ import annotations

import contextlib
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
    """BatchNorm over dim 1 with torch's eps 1e-5 and flax's rules
    (emotiongestures_tpu/core/layers.py:119-140). Holds no
    `num_batches_tracked`: the JAX tree has none.

    Eval mode: mul = rsqrt(var + eps) * scale in the stats' and scale's
    type, then one fused pass y = x * mul + (bias - mean * mul) in fp32.
    Train mode: mean and biased variance of the batch over every dim but 1,
    in at least fp32; y = (x - mean) * rsqrt(var + eps) * scale + bias in
    that type; the running stats take both unless `write_stats` is off.
    Either way the output has the promoted type of x, scale and bias."""

    momentum = 0.9  # flax's: running = momentum * running + (1 - m) * batch

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.write_stats = True
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        out_dtype = promoted(x, self.weight, self.bias)
        if self.training:
            x32 = x.to(torch.promote_types(x.dtype, torch.float32))
            dims = [0] + list(range(2, x.ndim))
            mean = x32.mean(dims)
            var = torch.clamp((x32 * x32).mean(dims) - mean * mean, min=0.0)
            if self.write_stats:
                self.update_running(mean.detach(), var.detach())
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = (x32 - mean.view(shape)) * mul.view(shape) + \
                self.bias.view(shape)
            return y.to(out_dtype)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        mul = mul.float()
        shift = self.bias.float() - self.running_mean.float() * mul
        y = torch.addcmul(shift.view(shape), x, mul.view(shape))
        return y.to(out_dtype)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """running = 0.9 * running + 0.1 * batch, the biased variance."""
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Train-mode BatchNorms inside `module` normalise with batch statistics
    but write no running statistics (flax's discarded `batch_stats`
    mutations)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [bn.write_stats for bn in bns]
    for bn in bns:
        bn.write_stats = False
    try:
        yield
    finally:
        for bn, flag in zip(bns, before):
            bn.write_stats = flag


class Dropout(nn.Dropout):
    """flax's dropout: keep with probability 1 - p, kept values divided by
    1 - p, in x's dtype. The mask comes from `generator` (see
    `dropout_generator`); without one, from torch's default generator."""

    generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        if keep == 0.0:
            return torch.zeros_like(x)
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


@contextlib.contextmanager
def dropout_generator(module: nn.Module, generator):
    """Every Dropout inside `module` draws its masks from `generator` (a
    torch.Generator on the module's device) for the duration."""
    drops = [m for m in module.modules() if isinstance(m, Dropout)]
    before = [d.generator for d in drops]
    for d in drops:
        d.generator = generator
    try:
        yield
    finally:
        for d, g in zip(drops, before):
            d.generator = g


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm: statistics in at least fp32, output in the
    promoted type of x, scale and bias."""

    def forward(self, x):
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
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
