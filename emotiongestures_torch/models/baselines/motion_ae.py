"""TED-expressive FGD feature net (port of
emotiongestures_tpu/models/baselines/motion_ae.py; reference
model/motion_ae.py:118-130): a conv pose autoencoder over 34-frame windows
of 126-d poses with a configurable latent. Poses are (B, T, D); the convs
run on (B, D, T) and flatten channel-major, as the reference's do.
"""
from __future__ import annotations

import torch.nn as nn

from ...core.device import resolve_device
from ...core.layers import BatchNorm, Conv1d, ConvTranspose1d, Linear
from .quirks import LeakyReLUTrue


def conv_norm_relu(cin, cout, downsample=False):
    """Conv1d (k3 s1, or k4 s2 when downsampling; no padding) ->
    BatchNorm -> LeakyReLU(0.2) (model/embedding_net.py:8-39)."""
    k, s = (4, 2) if downsample else (3, 1)
    return nn.Sequential(Conv1d(cin, cout, k, stride=s), BatchNorm(cout),
                         nn.LeakyReLU(0.2))


def conv_out_length(length: int) -> int:
    """Frames left after the encoders' k3, k3, k4 s2, k3 valid convs."""
    return ((length - 4) - 4) // 2 + 1 - 2


class PoseConvNet(nn.Module):
    """The shared encoder trunk: three conv_norm_relu, a k3 conv to 32
    channels and the out_net MLP (Linear -> BatchNorm -> LeakyReLU(True)
    twice, then Linear to `out_dim`)."""

    def __init__(self, length, pose_dim, out_dim):
        super().__init__()
        self.net = nn.Sequential(
            conv_norm_relu(pose_dim, 32), conv_norm_relu(32, 64),
            conv_norm_relu(64, 64, downsample=True), Conv1d(64, 32, 3))
        self.out_net = nn.Sequential(
            Linear(32 * conv_out_length(length), 256), BatchNorm(256),
            LeakyReLUTrue(), Linear(256, 128), BatchNorm(128),
            LeakyReLUTrue(), Linear(128, out_dim))

    def forward(self, poses):  # (B, T, D)
        x = self.net(poses.transpose(1, 2))
        return self.out_net(x.flatten(1))


def deconv_net(pose_dim):
    """The decoders' tail over (B, 4, L): two ConvTranspose1d k3 -> BatchNorm
    -> LeakyReLU(0.2), then two k3 convs; L + 4 - 4 frames out."""
    return nn.Sequential(
        ConvTranspose1d(4, 32, 3), BatchNorm(32), nn.LeakyReLU(0.2),
        ConvTranspose1d(32, 32, 3), BatchNorm(32), nn.LeakyReLU(0.2),
        Conv1d(32, 32, 3), Conv1d(32, pose_dim, 3))


class PoseDecoder(nn.Module):
    """MotionAE's decoder: latent -> Linear(64) -> BatchNorm ->
    LeakyReLU(True) -> Linear(136) -> (B, 4, 34) -> deconv_net."""

    def __init__(self, pose_dim, latent_dim):
        super().__init__()
        self.pre_net = nn.Sequential(Linear(latent_dim, 64), BatchNorm(64),
                                     LeakyReLUTrue(), Linear(64, 136))
        self.net = deconv_net(pose_dim)

    def forward(self, z):
        x = self.pre_net(z).view(z.shape[0], 4, -1)
        return self.net(x).transpose(1, 2)  # (B, T, D)


class MotionAE(nn.Module):
    """pose (B, T, ...) -> (reconstruction (B, 34, pose_dim), z (B, latent));
    the decoder always writes 34 frames, as the reference's does."""

    def __init__(self, pose_dim: int = 126, latent_dim: int = 128,
                 length: int = 34, device=None):
        super().__init__()
        self.encoder = PoseConvNet(length, pose_dim, latent_dim)  # z only
        self.decoder = PoseDecoder(pose_dim, latent_dim)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, pose):
        pose = pose.reshape(pose.shape[0], pose.shape[1], -1)
        z = self.encoder(pose)
        return self.decoder(z), z
