"""Audio emotion classifier (port of emotiongestures_tpu/models/emotion_net.py;
reference model/audio_emotion_classifer.py:17-70): a 4-stage SE-ResNet over
(B, 128, 124) log-mel windows -> flatten (B, 256 * 16 * 16) -> MLP -> 8
emotion logits.

Attribute names are the reference's, its misspelled `emotion_eocder_fc`
included, so its state_dicts load with strict=True. flax infers fc0's fan-in
from the input at init; here `spec_shape` gives it: each stride-2 stage maps
n to ceil(n / 2). The flatten is in (C, H, W) order, the port's native NCHW,
which is the reference's layout. Built on `device` (the card unless the CPU
is asked for), in eval mode.
"""
from __future__ import annotations

import math

import torch.nn as nn

from ..core.device import resolve_device
from ..core.layers import Linear
from ..nn.resnet_se import ResNetSE

LAYERS = (3, 4, 6, 3)
NUM_FILTERS = (32, 64, 128, 256)
MLP_WIDTHS = (4096, 2048, 512, 128, 64)


def flat_features(spec_shape) -> int:
    """fc0's fan-in for a (H, W) spectrogram: the last stage's channels
    times its map, each of the three stride-2 stages halving H and W."""
    h, w = spec_shape
    for _ in LAYERS[1:]:
        h, w = math.ceil(h / 2), math.ceil(w / 2)
    return NUM_FILTERS[-1] * h * w


class EmotionNet(nn.Module):
    def __init__(self, num_classes: int = 8, spec_shape=(128, 124),
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.emotion_encoder = ResNetSE(LAYERS, NUM_FILTERS)
        layers, fan_in = [], flat_features(spec_shape)
        for width in MLP_WIDTHS:
            layers += [Linear(fan_in, width), nn.ReLU()]
            fan_in = width
        self.emotion_eocder_fc = nn.Sequential(*layers)
        self.last_fc = Linear(fan_in, num_classes)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, spec):
        """(B, H, W) log-mel -> (B, num_classes) logits."""
        x = self.emotion_encoder(spec[:, None])
        return self.last_fc(self.emotion_eocder_fc(x.flatten(1)))


class DisNet(nn.Module):
    """Tiny MLP discriminator head (model/audio_emotion_classifer.py:51-70):
    128 -> 64 -> 16 -> 1, ReLU after each. Unused by the entry points; part
    of the inventory."""

    def __init__(self, device=None):
        super().__init__()
        self.dis_fc = nn.Sequential(
            Linear(128, 64), nn.ReLU(), Linear(64, 16), nn.ReLU(),
            Linear(16, 1), nn.ReLU())
        self.to(resolve_device(device))
        self.eval()

    def forward(self, feature):
        return self.dis_fc(feature)
