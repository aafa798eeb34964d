"""Squeeze-excitation ResNet over spectrogram images, NCHW
(port of emotiongestures_tpu/nn/resnet_se.py).

Reference quirks kept: SEBasicBlock's first leg is conv -> relu -> bn
(Full_model/ResNetBlocks.py:24-29) and the stem is conv3x3 -> relu -> bn
(Full_model/ResNetSE34V2.py:62-66); SEBottleneck
(Full_model/ResNetBlocks.py:40-78) has the standard conv-bn-relu order and
expansion 4. The 3-stage variant (layers 3-4-6, filters 32-64-128) is the
generator's audio encoder, the 4-stage one (3-4-6-3, 32-64-128-256) the
audio emotion classifier's backbone. Convolutions are cuDNN's, as the JAX
package leaves them to XLA and runs them in no Pallas kernel.

`remat_blocks=True` is the JAX package's `nn.remat` per block: in training,
each residual block runs under `torch.utils.checkpoint` (non-reentrant), so
the backward recomputes its activations instead of keeping them. The JAX
package's `scan_blocks` (a stage's stride-1 blocks as one lax.scan, which
shrinks XLA's traced graph) has no counterpart in eager PyTorch and is not
ported.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..core.init import kaiming_normal_fan_out_
from ..core.layers import BatchNorm, Conv2d, Linear, frozen_stats


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


def _downsample(inplanes, planes, stride, expansion):
    """The residual's 1x1 conv + BatchNorm where the block changes shape."""
    if stride == 1 and inplanes == planes * expansion:
        return None
    conv = Conv2d(inplanes, planes * expansion, 1, stride=stride, bias=False)
    kaiming_normal_fan_out_(conv.weight)
    return nn.Sequential(conv, BatchNorm(planes * expansion))


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
        self.downsample = _downsample(inplanes, planes, stride,
                                      self.expansion)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.bn1(torch.relu(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        return torch.relu(out + residual)


class SEBottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4, each conv-bn, relu between, the SE
    gate on the widened output (Full_model/ResNetBlocks.py:40-78)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 reduction: int = 8):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv3x3(planes, planes, stride)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        for conv in (self.conv1, self.conv3):
            kaiming_normal_fan_out_(conv.weight)
        self.se = SELayer(planes * 4, reduction)
        self.downsample = _downsample(inplanes, planes, stride,
                                      self.expansion)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.se(self.bn3(self.conv3(out)))
        return torch.relu(out + residual)


class ResNetSE(nn.Module):
    """Stages of `block`s over (B, 1, H, W): stage 1 stride 1, later stages
    stride 2 (Full_model/ResNetSE34V2.py:26-29)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6),
                 num_filters: Sequence[int] = (32, 64, 128),
                 reduction: int = 8, remat_blocks: bool = False,
                 block=SEBasicBlock):
        super().__init__()
        self.remat_blocks = remat_blocks
        self.conv1 = Conv2d(1, num_filters[0], 3, padding=1)
        kaiming_normal_fan_out_(self.conv1.weight)
        self.bn1 = BatchNorm(num_filters[0])
        inplanes = num_filters[0]
        for stage, (planes, blocks) in enumerate(zip(num_filters, layers)):
            stride = 1 if stage == 0 else 2
            stack = [block(inplanes, planes, stride, reduction)]
            inplanes = planes * block.expansion
            stack += [block(inplanes, planes, 1, reduction)
                      for _ in range(1, blocks)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*stack))
        self.n_stages = len(layers)

    def forward(self, x):
        x = self.bn1(torch.relu(self.conv1(x)))
        remat = self.remat_blocks and self.training and \
            torch.is_grad_enabled()
        for stage in range(self.n_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                x = _remat(block, x) if remat else block(x)
        return x


def _remat(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """`block(x)` under a non-reentrant checkpoint. The parameters the block
    holds now (under `torch.func.functional_call`, the caller's cast copies)
    go in as inputs, so the recomputation in the backward uses them and not
    whatever the module holds by then. The block has no dropout, so the
    recomputation sees the same batch; it writes no running statistics, the
    first pass did."""
    names, tensors = zip(*block.named_parameters())
    calls = []

    def run(inp, *params):
        state = dict(zip(names, params))
        if calls:
            with frozen_stats(block):
                return functional_call(block, state, (inp,))
        calls.append(True)
        return functional_call(block, state, (inp,))

    return checkpoint(run, x, *tensors, use_reentrant=False)
