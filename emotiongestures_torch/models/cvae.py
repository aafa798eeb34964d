"""Emotion-prior CVAEs (port of emotiongestures_tpu/models/cvae.py;
reference CAVE/BEAT_CVAE.py and Full_model/BEAT_CVAE.py).

EmotionCVAEv3 (CAVE/BEAT_CVAE.py:312-460 MLP_Reconstruct_v3) is the
production prior: features (B, 60, 512) with the 60 frames as conv channels
and a one-hot emotion (B, 8). EmotionCVAEv1 and EmotionCVAEv2
(CAVE/BEAT_CVAE.py:30-154, 157-308) are its per-frame MLP predecessors, and
HandCVAE (Full_model/BEAT_CVAE.py:30-149) the legacy per-frame 90-d hand
CVAE with a 90-d pose as its condition. Their MLP stacks are the reference's
nn.Sequential(Linear, Dropout, Linear, ...): no activation between the
Linears. The reference's v1/v2 `sample` crashes on an undefined `Input`;
these implement what it meant, as the JAX package does.

`forward(x, y, noise=None, generator=None)` is the posterior pass,
(reconstruction, mu, logvar); `sample(y, noise=None, generator=None)` is the
prior: z ~ N(0, I) in fp32 from an explicit torch.Generator, or the caller's
`noise`. z in fp32 promotes the decode that follows, so under bf16 weights
the decoder computes in fp32, as in the JAX package. Under data parallelism
z is this rank's rows of the global batch's draw (parallel/mesh.py), as the
JAX package's noise is a slice of one global draw.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..core.layers import (BatchNorm, Conv1d, ConvTranspose1d, Dropout,
                           Linear, promoted)
from ..parallel.mesh import global_randn


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
            noise = global_randn(std.shape, generator, std.device,
                                 std.dtype)
        z = noise * std + mu
        return self.fuse_decode(z, self.y_embed(y)), mu, logvar

    def sample(self, y, noise=None, generator=None):
        """Prior sampling (CAVE/BEAT_CVAE.py:427-447): (B, frames, feat_dim).
        `noise` (B, latent_dim) stands in for z when given."""
        post_y = self.y_embed(y)
        if noise is None:
            noise = global_randn((y.shape[0], self.latent_dim), generator,
                                 y.device, torch.float32)
        return self.fuse_decode(noise, post_y)


def _mlp_stack(d_in, features, p=0.2):
    """Linear, Dropout, Linear, ... over `features`, no activation."""
    layers = []
    for i, f in enumerate(features):
        if i:
            layers.append(Dropout(p))
        layers.append(Linear(d_in, f))
        d_in = f
    return nn.Sequential(*layers)


class _MLPCVAE(nn.Module):
    """The per-frame MLP CVAEs' shared skeleton: an encoder, mu / logvar
    heads, a y embedding, the fusion of z and the embedding, a decoder.
    `frame_width` is the width of one frame between the fusion and the
    decoder (32), or 0 where a sample is one row (HandCVAE)."""

    frame_width = 0

    def _finish(self, device):
        self.to(resolve_device(device))
        self.eval()

    def y_embed(self, y):
        return self.Posterior_Y_embedding(y)

    def fuse_decode(self, z, post_y):
        dt = promoted(z, post_y)
        h = self.fusion_z_posterior(torch.cat([z.to(dt), post_y.to(dt)],
                                              dim=1))
        if self.frame_width:
            h = h.view(z.shape[0], -1, self.frame_width)
        return self.Decoder(h)

    def forward(self, x, y, noise=None, generator=None):
        """Posterior pass: (reconstruction, mu, logvar)."""
        enc = self.Encoder(x).flatten(1)
        mu, logvar = self.fc_mu(enc), self.fc_var(enc)
        std = torch.exp(0.5 * logvar)
        if noise is None:
            noise = global_randn(std.shape, generator, std.device,
                                 std.dtype)
        z = noise * std + mu
        return self.fuse_decode(z, self.y_embed(y)), mu, logvar

    def sample(self, y, noise=None, generator=None):
        """Prior sampling; `noise` (B, latent_dim) stands in for z."""
        post_y = self.y_embed(y)
        if noise is None:
            noise = global_randn((y.shape[0], self.latent_dim), generator,
                                 y.device, torch.float32)
        return self.fuse_decode(noise, post_y)


_ENC5 = (512, 256, 128, 64, 32)
_DEC5 = (64, 128, 256, 512, 512)


class EmotionCVAEv1(_MLPCVAE):
    """MLP CVAE (CAVE/BEAT_CVAE.py:30-154): a per-frame encoder
    feat_dim -> 512 -> ... -> 32, single-Linear fc_mu / fc_var over the
    flattened (frames x 32) encoding, fusion to frames x 32 and a per-frame
    decoder 32 -> ... -> 512. The decoder ends at 512 whatever `feat_dim`
    is, as in the reference."""

    frame_width = 32

    def __init__(self, latent_dim: int = 32, frames: int = 60,
                 feat_dim: int = 512, n_emotions: int = 8, device=None):
        super().__init__()
        self.latent_dim, self.frames = latent_dim, frames
        flat = frames * 32
        self.Encoder = _mlp_stack(feat_dim, _ENC5)
        self.Posterior_Y_embedding = _mlp_stack(n_emotions, (16, 32))
        self.fc_mu = Linear(flat, latent_dim)
        self.fc_var = Linear(flat, latent_dim)
        self.Decoder = _mlp_stack(32, _DEC5)
        self.fusion_z_posterior = _mlp_stack(latent_dim + 32, (flat, flat))
        self._finish(device)


class EmotionCVAEv2(_MLPCVAE):
    """EmotionCVAEv1 with deeper fc_mu / fc_var (frames x 32 -> 1024 -> 512
    -> 256 -> 64 -> latent) and fusion (-> 256 -> 512 -> 1024 -> frames x
    32) stacks (CAVE/BEAT_CVAE.py:157-308)."""

    frame_width = 32

    def __init__(self, latent_dim: int = 32, frames: int = 60,
                 feat_dim: int = 512, n_emotions: int = 8, device=None):
        super().__init__()
        self.latent_dim, self.frames = latent_dim, frames
        flat = frames * 32
        self.Encoder = _mlp_stack(feat_dim, _ENC5)
        self.Posterior_Y_embedding = _mlp_stack(n_emotions, (16, 32))
        self.fc_mu = _mlp_stack(flat, (1024, 512, 256, 64, latent_dim))
        self.fc_var = _mlp_stack(flat, (1024, 512, 256, 64, latent_dim))
        self.Decoder = _mlp_stack(32, _DEC5)
        self.fusion_z_posterior = _mlp_stack(latent_dim + 32,
                                             (256, 512, 1024, flat))
        self._finish(device)


class HandCVAE(_MLPCVAE):
    """The legacy per-frame hand CVAE (Full_model/BEAT_CVAE.py:30-149):
    x (B, 90) hand pose, y (B, 90) condition pose; encoder 90 -> 128 -> 128
    -> 256 -> 256 -> 512, z ⊕ y-embedding (90 -> 64 -> 32), fusion 64 ->
    256 -> 512, decoder 512 -> 256 -> 256 -> 128 -> 128 -> 90."""

    def __init__(self, latent_dim: int = 32, hand_dim: int = 90,
                 device=None):
        super().__init__()
        self.latent_dim = latent_dim
        self.Encoder = _mlp_stack(hand_dim, (128, 128, 256, 256, 512))
        self.Posterior_Y_embedding = _mlp_stack(hand_dim, (64, 32))
        self.fc_mu = Linear(512, latent_dim)
        self.fc_var = Linear(512, latent_dim)
        self.Decoder = _mlp_stack(512, (256, 256, 128, 128, hand_dim))
        self.fusion_z_posterior = _mlp_stack(latent_dim + 32, (256, 512))
        self._finish(device)
