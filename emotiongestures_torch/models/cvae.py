"""Emotion-prior conv CVAE (port of emotiongestures_tpu/models/cvae.py,
EmotionCVAEv3; reference CAVE/BEAT_CVAE.py:312-460 MLP_Reconstruct_v3).

Takes features (B, 60, 512) with the 60 frames as conv channels and a one-hot
emotion (B, 8). `sample(y, noise=None, generator=None)` is the diversity
prior: z ~ N(0, I) in fp32 from an explicit torch.Generator, or the caller's
`noise`. z in fp32 promotes the decode that follows, so under bf16 weights
the decoder computes in fp32, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..core.layers import (BatchNorm, Conv1d, ConvTranspose1d, Dropout,
                           Linear, promoted)


def _lrelu():
    return nn.LeakyReLU(0.2)


class EmotionCVAEv3(nn.Module):
    def __init__(self, latent_dim: int = 32, frames: int = 60,
                 feat_dim: int = 512, n_emotions: int = 8, device=None):
        super().__init__()
        self.latent_dim, self.frames, self.feat_dim = latent_dim, frames, feat_dim
        enc = []
        cin = frames
        for ch, k, s in [(32, 3, 1), (16, 3, 1), (8, 5, 2), (4, 5, 2)]:
            enc += [Conv1d(cin, ch, k, stride=s, padding=k // 2), _lrelu(),
                    BatchNorm(ch)]
            cin = ch
        self.Encoder = nn.Sequential(*enc)
        self.Posterior_Y_embedding = nn.Sequential(
            Linear(n_emotions, 16), Dropout(0.2), Linear(16, 32))
        self.fc_mu = nn.Sequential(Linear(feat_dim, 128), Dropout(0.2),
                                   Linear(128, latent_dim))
        self.fc_var = nn.Sequential(Linear(feat_dim, 128), Dropout(0.2),
                                    Linear(128, latent_dim))
        self.fusion_z_posterior = nn.Sequential(
            Linear(latent_dim + 32, 128), Dropout(0.2),
            Linear(128, 4 * (feat_dim // 4)))
        self.Decoder = nn.Sequential(
            ConvTranspose1d(4, 8, 3, stride=2, padding=1, output_padding=1),
            _lrelu(), BatchNorm(8),
            ConvTranspose1d(8, 16, 3, stride=2, padding=1, output_padding=1),
            _lrelu(), BatchNorm(16),
            Conv1d(16, 32, 3, padding=1), _lrelu(), BatchNorm(32),
            Conv1d(32, frames, 3, padding=1), _lrelu(), BatchNorm(frames),
            Conv1d(frames, frames, 3, padding=1))
        self.to(resolve_device(device))
        self.eval()

    def y_embed(self, y):
        return self.Posterior_Y_embedding(y)

    def fuse_decode(self, z, post_y):
        dt = promoted(z, post_y)
        h = torch.cat([z.to(dt), post_y.to(dt)], dim=1)
        h = self.fusion_z_posterior(h).view(z.shape[0], 4, self.feat_dim // 4)
        return self.Decoder(h)  # (B, frames, feat_dim)

    def forward(self, x, y, noise=None, generator=None):
        """Posterior pass: (reconstruction, mu, logvar)."""
        enc = self.Encoder(x).flatten(1)
        mu, logvar = self.fc_mu(enc), self.fc_var(enc)
        std = torch.exp(0.5 * logvar)
        if noise is None:
            noise = torch.randn(std.shape, generator=generator,
                                device=std.device, dtype=std.dtype)
        z = noise * std + mu
        return self.fuse_decode(z, self.y_embed(y)), mu, logvar

    def sample(self, y, noise=None, generator=None):
        """Prior sampling (CAVE/BEAT_CVAE.py:427-447): (B, frames, feat_dim).
        `noise` (B, latent_dim) stands in for z when given."""
        post_y = self.y_embed(y)
        if noise is None:
            noise = torch.randn((y.shape[0], self.latent_dim),
                                generator=generator, device=y.device,
                                dtype=torch.float32)
        return self.fuse_decode(noise, post_y)
