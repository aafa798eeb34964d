"""Layer factories of the reference's model/audio_emotion_classifer_
submodules.py (port of emotiongestures_tpu/models/legacy_submodules.py),
which no entry point imports.

Each factory returns nn.Sequential(core layer, BatchNorm, activation), the
reference's `_apply` order (:90-95); the core layer has a bias only when
there is no normalizer (:30). `conv3d`, which the reference's
ResidualBlock calls but never defines (:13-14), is the conv2d factory over
volumes, as in the JAX package, so ResidualBlock builds. ResidualBlock's
final `nn.ReLU(0.2)` passes 0.2 as `inplace`: a plain ReLU, kept.

Layouts are PyTorch's NCHW / NCDHW (the JAX package's are channel-last),
and since torch's layers are not lazy every factory takes the input width
first. `activation` is a module class or factory (default nn.ReLU), or
None. `conv_transpose2d` is torch's ConvTranspose2d with the reference's
arguments, whose `padding` removes output rows (lax's adds them; the JAX
package converts).

The JAX package has no weight table for these; the names are the port's:
the Sequentials' indices (`0` the core layer, `1` the BatchNorm;
`nn_conv2d`'s upsampling is index 0, so its layer and norm are `1`, `2`)
and ResidualBlock's `block0` / `block1` (the JAX module's). Loading a
reference `.pth` into them is unverified: the reference tree was not at
hand.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.layers import BatchNorm, Conv2d, Linear


def _seq(core, channel_out, activation, normalizer, prefix=()):
    layers = list(prefix) + [core]
    if normalizer:
        layers.append(BatchNorm(channel_out))
    if activation is not None:
        layers.append(activation())
    return nn.Sequential(*layers)


def linear(channel_in, channel_out, activation=nn.ReLU, normalizer=True):
    """Linear -> BatchNorm1d -> activation (:26-37)."""
    return _seq(Linear(channel_in, channel_out, bias=not normalizer),
                channel_out, activation, normalizer)


def conv2d(channel_in, channel_out, ksize=3, stride=1, padding=1,
           activation=nn.ReLU, normalizer=True):
    """Conv2d -> BatchNorm2d -> activation (:40-53)."""
    return _seq(Conv2d(channel_in, channel_out, ksize, stride, padding,
                       bias=not normalizer),
                channel_out, activation, normalizer)


def conv3d(channel_in, channel_out, ksize=3, stride=1, padding=1,
           activation=nn.ReLU, normalizer=True):
    """The conv2d factory over (B, C, D, H, W) volumes: the member the
    reference's ResidualBlock calls and never defines."""
    return _seq(nn.Conv3d(channel_in, channel_out, ksize, stride, padding,
                       bias=not normalizer),
                channel_out, activation, normalizer)


def conv_transpose2d(channel_in, channel_out, ksize=4, stride=2, padding=1,
                     activation=nn.ReLU, normalizer=True):
    """ConvTranspose2d -> BatchNorm2d -> activation (:56-69); the defaults
    double H and W."""
    return _seq(nn.ConvTranspose2d(channel_in, channel_out, ksize, stride,
                                padding, bias=not normalizer),
                channel_out, activation, normalizer)


def nn_conv2d(channel_in, channel_out, ksize=3, stride=1, padding=1,
              scale_factor=2, activation=nn.ReLU, normalizer=True):
    """UpsamplingNearest2d(scale) -> Conv2d -> BatchNorm2d -> activation
    (:72-87)."""
    return _seq(Conv2d(channel_in, channel_out, ksize, stride, padding,
                       bias=not normalizer),
                channel_out, activation, normalizer,
                prefix=(nn.UpsamplingNearest2d(scale_factor=scale_factor),))


class ResidualBlock(nn.Module):
    """The 3-D residual block (:8-25): conv3d -> conv3d without activation
    -> + x -> ReLU (plain: the reference's ReLU(0.2) is `inplace=0.2`)."""

    def __init__(self, channel_out):
        super().__init__()
        self.block0 = conv3d(channel_out, channel_out)
        self.block1 = conv3d(channel_out, channel_out, activation=None)

    def forward(self, x):
        return torch.relu(self.block1(self.block0(x)) + x)
