"""Adversarial discriminators (port of emotiongestures_tpu/models/
discriminator.py; reference Full_model/Models_memory.py:569-618 and
Full_model/Models.py:482-510).

MotionDiscriminator scores 59-frame motion offsets (`calc_motion`,
test_...py:41-44) with raw logits, no sigmoid. The reference's defaults
(d_model 128 beside a pose_dim-wide encoder) only typecheck at d_model ==
pose_dim, so d_model defaults to pose_dim, as in the JAX package. The
attention-probability dropout stays at the reference's 0.1 whatever
`dropout` is (Full_model/SubLayers.py:25). PoseDiscriminator scores each
frame with a sigmoid head.

Attribute names are the reference's (`encoder`, `fc1.0`, `fc2.{0..10}`;
`encoder`, `fc.{0,2}`), so `utils/weights.py`'s tables load with
strict=True. Built on `device` (the card unless the CPU is asked for), in
eval mode.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..core.layers import Dropout, Linear
from ..nn.transformer import TransformerEncoder


class MotionDiscriminator(nn.Module):
    def __init__(self, frames=59, pose_dim=282, d_model=282, d_inner=1024,
                 n_layers=2, n_head=8, d_k=64, d_v=64, dropout=0.2,
                 device=None):
        super().__init__()
        self.encoder = TransformerEncoder(n_layers, n_head, d_k, d_v,
                                          d_model, d_inner, dropout,
                                          n_position=frames)
        self.fc1 = nn.Sequential(Linear(d_model, 64), nn.ReLU())
        widths = [64 * frames, 2048, 1024, 256, 64, 16]
        stack = []
        for d_in, d_out in zip(widths, widths[1:]):
            stack += [Linear(d_in, d_out), nn.ReLU()]
        self.fc2 = nn.Sequential(*stack, Linear(16, 1))
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x):  # (B, frames, pose_dim) -> (B, 1) raw logits
        x = self.fc1(self.encoder(x))
        return self.fc2(x.reshape(x.shape[0], -1))


class PoseDiscriminator(nn.Module):
    def __init__(self, frames=60, pose_dim=282, d_model=282, d_inner=1024,
                 n_layers=3, n_head=8, d_k=64, d_v=64, dropout=0.2,
                 device=None):
        super().__init__()
        self.encoder = TransformerEncoder(n_layers, n_head, d_k, d_v,
                                          d_model, d_inner, dropout,
                                          n_position=frames)
        self.fc = nn.Sequential(Linear(d_model, 64), Dropout(0.2),
                                Linear(64, 1))
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x):  # (B, frames, pose_dim) -> (B, frames, 1) probs
        return torch.sigmoid(self.fc(self.encoder(x)))


def calc_motion(motion: torch.Tensor) -> torch.Tensor:
    """Frame-difference offsets (test_...py:41-44): (B, T, D) ->
    (B, T - 1, D)."""
    return motion[:, 1:] - motion[:, :-1]
