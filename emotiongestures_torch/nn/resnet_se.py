"""Squeeze-excitation ResNet over spectrogram images, NCHW
(port of emotiongestures_tpu/nn/resnet_se.py, 3-stage generator variant).

Reference quirks kept: SEBasicBlock's first leg is conv -> relu -> bn
(Full_model/ResNetBlocks.py:24-29) and the stem is conv3x3 -> relu -> bn
(Full_model/ResNetSE34V2.py:62-66). Convolutions are cuDNN's, as the JAX
package leaves them to XLA and runs them in no Pallas kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..core.init import kaiming_normal_fan_out_
from ..core.layers import BatchNorm, Conv2d, Linear


class SELayer(nn.Module):
    """Squeeze-excitation gate (Full_model/ResNetBlocks.py:81-96)."""

    def __init__(self, channel: int, reduction: int = 8):
        super().__init__()
        self.fc = nn.Sequential(Linear(channel, channel // reduction),
                                nn.ReLU(),
                                Linear(channel // reduction, channel),
                                nn.Sigmoid())

    def forward(self, x):  # (B, C, H, W)
        y = self.fc(x.mean(dim=(2, 3)))
        return x * y[:, :, None, None]


def _conv3x3(cin, cout, stride=1, bias=False):
    conv = Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)
    kaiming_normal_fan_out_(conv.weight)
    return conv


class SEBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 reduction: int = 8):
        super().__init__()
        self.conv1 = _conv3x3(inplanes, planes, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = BatchNorm(planes)
        self.se = SELayer(planes, reduction)
        self.downsample = None
        if stride != 1 or inplanes != planes * self.expansion:
            conv = Conv2d(inplanes, planes * self.expansion, 1, stride=stride,
                          bias=False)
            kaiming_normal_fan_out_(conv.weight)
            self.downsample = nn.Sequential(
                conv, BatchNorm(planes * self.expansion))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.bn1(torch.relu(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        return torch.relu(out + residual)


class ResNetSE(nn.Module):
    """Stages of SEBasicBlocks over (B, 1, H, W): stage 1 stride 1, later
    stages stride 2 (Full_model/ResNetSE34V2.py:26-29)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6),
                 num_filters: Sequence[int] = (32, 64, 128),
                 reduction: int = 8):
        super().__init__()
        self.conv1 = Conv2d(1, num_filters[0], 3, padding=1)
        kaiming_normal_fan_out_(self.conv1.weight)
        self.bn1 = BatchNorm(num_filters[0])
        inplanes = num_filters[0]
        for stage, (planes, blocks) in enumerate(zip(num_filters, layers)):
            stride = 1 if stage == 0 else 2
            stack = [SEBasicBlock(inplanes, planes, stride, reduction)]
            inplanes = planes * SEBasicBlock.expansion
            stack += [SEBasicBlock(inplanes, planes, 1, reduction)
                      for _ in range(1, blocks)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*stack))
        self.n_stages = len(layers)

    def forward(self, x):
        x = self.bn1(torch.relu(self.conv1(x)))
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x
