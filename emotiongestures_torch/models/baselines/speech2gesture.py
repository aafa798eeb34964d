"""Speech2Gesture baseline (port of emotiongestures_tpu/models/baselines/
speech2gesture.py; reference model/speech2gesture.py:106-259): a
spectrogram conv downstack, a resize to n_frames, a 1-D U-Net; a patch
discriminator on pose differences. Sequences are (B, T, C) at the
boundary, (B, C, T) inside.

The convolutions pad as TensorFlow's "SAME" (the reference's Conv1d_tf /
Conv2d_tf shims, and lax's "SAME" in the JAX package): total padding
max((ceil(n / s) - 1) s + k - n, 0), the smaller half first. The make_1d
step is the JAX package's `jax.image.resize(..., "bilinear")`, which
antialiases when it shrinks an axis: `resize_weights` builds its weight
matrices on the host and the resize is two small products on the device.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.device import resolve_device
from ...core.layers import BatchNorm, Conv1d, Conv2d, Linear


def _same_pad(n, k, s):
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv1d(Conv1d):
    """Conv1d with TensorFlow's "SAME" padding at any stride."""

    def forward(self, x):
        lo, hi = _same_pad(x.shape[-1], self.kernel_size[0], self.stride[0])
        return super().forward(F.pad(x, (lo, hi)))


class SameConv2d(Conv2d):
    """Conv2d with TensorFlow's "SAME" padding at any stride."""

    def forward(self, x):
        h = _same_pad(x.shape[-2], self.kernel_size[0], self.stride[0])
        w = _same_pad(x.shape[-1], self.kernel_size[1], self.stride[1])
        return super().forward(F.pad(x, (*w, *h)))


def conv_norm_relu(cin, cout, ndim=1, downsample=False, k=None, s=None,
                   same=True):
    """conv -> BatchNorm -> LeakyReLU(0.2) (speech2gesture.py:106-128); k4 s2
    when downsampling, else k3 s1; `same=False` pads nothing."""
    k = k if k is not None else (4 if downsample else 3)
    s = s if s is not None else (2 if downsample else 1)
    if same:
        conv = (SameConv1d if ndim == 1 else SameConv2d)(cin, cout, k,
                                                          stride=s)
    else:
        conv = (Conv1d if ndim == 1 else Conv2d)(cin, cout, k, stride=s)
    return nn.Sequential(conv, BatchNorm(cout), nn.LeakyReLU(0.2))


@functools.lru_cache(maxsize=16)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of jax.image.resize's "bilinear" (antialiased)
    along one axis: a triangle kernel, widened by n_in / n_out when
    shrinking, at the half-pixel sample positions, each column normalised
    (jax/_src/image/scale.py::compute_weight_mat)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_bilinear(x, height, width):
    """(B, C, H, W) -> (B, C, height, width), jax.image.resize's
    "bilinear"."""
    wh = torch.from_numpy(resize_weights(x.shape[2], height)).to(x)
    ww = torch.from_numpy(resize_weights(x.shape[3], width)).to(x)
    return torch.einsum("bchw,hy,wx->bcyx", x, wh, ww)


class UnetUp(nn.Module):
    """(speech2gesture.py:131-141): repeat each frame twice, crop to the
    skip's length, add the skip, conv_norm_relu."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = conv_norm_relu(cin, cout)

    def forward(self, x1, x2):
        x1 = x1.repeat_interleave(2, dim=2)[:, :, : x2.shape[2]]
        return self.conv(x1 + x2)


class S2GAudioEncoder(nn.Module):
    """(speech2gesture.py:144-199): spectrogram (B, n_mels, T) -> (B, 256,
    n_frames)."""

    def __init__(self, n_frames):
        super().__init__()
        self.n_frames = n_frames
        chans = [(64, False), (64, True), (128, False), (128, True),
                 (256, False), (256, True), (256, False)]
        first, cin = [], 1
        for c, down in chans:
            first.append(conv_norm_relu(cin, c, ndim=2, downsample=down))
            cin = c
        first.append(conv_norm_relu(256, 256, ndim=2, same=False))
        self.first_net = nn.Sequential(*first)
        self.down1 = nn.Sequential(conv_norm_relu(256, 256),
                                   conv_norm_relu(256, 256))
        for i in range(2, 7):
            setattr(self, f"down{i}", conv_norm_relu(256, 256,
                                                     downsample=True))
        for i in range(1, 6):
            setattr(self, f"up{i}", UnetUp(256, 256))

    def forward(self, spectrogram):
        x = self.first_net(spectrogram[:, None].float())
        x1 = resize_bilinear(x, self.n_frames, 1)[..., 0]  # (B, 256, T)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x6 = self.down5(x5)
        x7 = self.down6(x6)
        x = self.up1(x7, x6)
        x = self.up2(x, x5)
        x = self.up3(x, x4)
        x = self.up4(x, x3)
        return self.up5(x, x2)


class S2GGenerator(nn.Module):
    """(speech2gesture.py:202-240): spectrogram (B, n_mels, T), seed poses
    (B, n_pre_poses, pose_dim) -> poses (B, n_poses, pose_dim)."""

    def __init__(self, n_poses=34, pose_dim=282, n_pre_poses=4,
                 device=None):
        super().__init__()
        self.n_poses = n_poses
        self.audio_encoder = S2GAudioEncoder(n_poses)
        self.pre_pose_encoder = nn.Sequential(
            Linear(n_pre_poses * pose_dim, 32), BatchNorm(32), nn.ReLU(),
            Linear(32, 16))
        self.decoder = nn.Sequential(
            conv_norm_relu(256 + 16, 256),
            *[conv_norm_relu(256, 256) for _ in range(3)])
        self.final_out = Conv1d(256, pose_dim, 1)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, in_spec, pre_poses):
        audio = self.audio_encoder(in_spec)  # (B, 256, T)
        p = self.pre_pose_encoder(pre_poses.flatten(1))
        p = p[:, :, None].expand(-1, -1, self.n_poses)
        feat = self.decoder(torch.cat([audio, p], dim=1))
        return self.final_out(feat).transpose(1, 2)


class S2GDiscriminator(nn.Module):
    """Patch discriminator on pose differences (speech2gesture.py:243-259):
    poses (B, T, pose_dim) -> (B, T', 1)."""

    def __init__(self, pose_dim=282, device=None):
        super().__init__()
        self.net = nn.Sequential(
            SameConv1d(pose_dim, 64, 4, stride=2), nn.LeakyReLU(0.2),
            conv_norm_relu(64, 128, downsample=True),
            conv_norm_relu(128, 256, k=4, s=1),
            SameConv1d(256, 1, 4))
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x):
        x = x[:, 1:] - x[:, :-1]
        return self.net(x.transpose(1, 2)).transpose(1, 2)
