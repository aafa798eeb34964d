"""Temporal convolutional network with weight norm, (B, C, L) layout
(port of emotiongestures_tpu/nn/tcn.py; Full_model/tcn.py:7-64).

Weight norm is written out: W = v * (g / max(||v||, 1e-12)), the norm per
output channel, with `weight_g` (out, 1, 1) and `weight_v` (out, in, k) kept
as parameters under the reference's names. The reference's pad-both-then-
chomp is a causal left pad of (k - 1) * dilation.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.layers import Conv1d, promoted


class WNCausalConv1d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int,
                 dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.pad = (kernel_size - 1) * dilation
        v = torch.randn(cout, cin, kernel_size) * 0.01
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(v.flatten(1).norm(dim=1)[:, None, None])
        bound = 1.0 / (cin * kernel_size) ** 0.5
        self.bias = nn.Parameter(torch.empty(cout).uniform_(-bound, bound))

    def forward(self, x):  # (B, Cin, L)
        v, g = self.weight_v, self.weight_g
        norm = torch.linalg.vector_norm(v.flatten(1), dim=1)[:, None, None]
        w = v * (g / torch.clamp(norm, min=1e-12))
        dt = promoted(x, w)
        y = F.conv1d(F.pad(x.to(dt), (self.pad, 0)), w.to(dt),
                     dilation=self.dilation)
        return y + self.bias.to(dt)[None, :, None]


class TemporalBlock(nn.Module):
    def __init__(self, n_inputs: int, n_outputs: int, kernel_size: int,
                 dilation: int, dropout: float = 0.2):
        super().__init__()
        self.conv1 = WNCausalConv1d(n_inputs, n_outputs, kernel_size, dilation)
        self.conv2 = WNCausalConv1d(n_outputs, n_outputs, kernel_size,
                                    dilation)
        self.dropout = nn.Dropout(dropout)
        self.downsample = None
        if n_inputs != n_outputs:
            self.downsample = Conv1d(n_inputs, n_outputs, 1)
            nn.init.normal_(self.downsample.weight, std=0.01)

    def forward(self, x):
        out = self.dropout(torch.relu(self.conv1(x)))
        out = self.dropout(torch.relu(self.conv2(out)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + res)


class TemporalConvNet(nn.Module):
    def __init__(self, num_inputs: int, num_channels: Sequence[int],
                 kernel_size: int = 2, dropout: float = 0.2):
        super().__init__()
        blocks = []
        for i, ch in enumerate(num_channels):
            cin = num_inputs if i == 0 else num_channels[i - 1]
            blocks.append(TemporalBlock(cin, ch, kernel_size, 2 ** i,
                                        dropout))
        self.network = nn.Sequential(*blocks)

    def forward(self, x):  # (B, C, L)
        return self.network(x)
