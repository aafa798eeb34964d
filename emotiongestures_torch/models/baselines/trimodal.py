"""Trimodal baseline (port of emotiongestures_tpu/models/baselines/
trimodal.py; reference model/multimodal_context_net.py): a raw-wave
encoder, a TCN text encoder and a speaker latent into a bidirectional GRU
pose generator; GRU and conv discriminators. Sequences are (B, T, C).

The speaker path's names (`speaker_embedding.0` the table, `.1` its Linear,
`speaker_mu`, `speaker_logvar`) are the ones the JAX package's table gives
the hierarchy generator, which shares this code in the reference; the JAX
package has no table for the trimodal speaker path, so loading a reference
`.pth` with speakers into it is unverified (the reference tree was not at
hand).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ...core.device import resolve_device
from ...core.layers import BatchNorm, Conv1d, Dropout, Linear
from ...nn.gru import GRU, sum_bidirectional
from ...nn.tcn import TemporalConvNet
from ...parallel.mesh import global_randn
from .quirks import LeakyReLUTrue


class WavEncoder(nn.Module):
    """Strided conv1d stack over the raw waveform
    (multimodal_context_net.py:13-40): (B, 64000) -> (B, frames, 32). Its
    fc1 Linear(frames, frames) mixes the time axis, as the reference's
    does; the wave's length must give `frames` steps (64000 samples give
    60)."""

    def __init__(self, frames: int = 60):
        super().__init__()
        self.feat_extractor = nn.Sequential(
            Conv1d(1, 16, 15, stride=5, padding=1600), BatchNorm(16),
            nn.LeakyReLU(0.3),
            Conv1d(16, 32, 15, stride=6), BatchNorm(32), nn.LeakyReLU(0.3),
            Conv1d(32, 64, 15, stride=6), BatchNorm(64), nn.LeakyReLU(0.3),
            Conv1d(64, 32, 15, stride=6))
        self.fc1 = nn.Sequential(Linear(frames, frames))

    def forward(self, wav):
        x = self.feat_extractor(wav[:, None])  # (B, 32, frames)
        return self.fc1(x).transpose(1, 2)


class TextEncoderTCN32(nn.Module):
    """The TCN text encoder with a 32-d output
    (multimodal_context_net.py:43-77): embedding -> TCN -> fc over the time
    axis -> Linear to 32. Returns (features (B, frames, 32), 0) as the
    reference does."""

    def __init__(self, n_words, embed_size=300, hidden_size=300, n_layers=3,
                 frames=60, dropout=0.3, emb_dropout=0.1):
        super().__init__()
        self.embedding = nn.Embedding(n_words, embed_size)
        nn.init.normal_(self.embedding.weight, std=1.0)
        self.emb_dropout = Dropout(emb_dropout)
        self.tcn = TemporalConvNet(embed_size, [hidden_size] * n_layers, 2,
                                   dropout)
        self.fc1 = nn.Sequential(Linear(frames, frames))
        self.decoder = Linear(hidden_size, 32)
        nn.init.normal_(self.decoder.weight, std=0.01)

    def forward(self, tokens):
        emb = self.emb_dropout(self.embedding(tokens))
        y = self.fc1(self.tcn(emb.transpose(1, 2))).transpose(1, 2)
        return self.decoder(y), 0


def add_speaker_latent(module, n_speakers, z_size):
    """Give `module` the speaker latent's layers under the reference's
    names: a table and a Linear (`speaker_embedding`), then `speaker_mu`
    and `speaker_logvar`."""
    module.speaker_embedding = nn.Sequential(
        nn.Embedding(n_speakers, z_size), Linear(z_size, z_size))
    nn.init.normal_(module.speaker_embedding[0].weight, std=1.0)
    module.speaker_mu = Linear(z_size, z_size)
    module.speaker_logvar = Linear(z_size, z_size)


def speaker_latent(module, vid, noise=None, generator=None):
    """(z, mu, logvar) of `module`'s speaker latent, z = mu + noise *
    exp(logvar / 2); `noise` stands in for the N(0, I) draw."""
    z = module.speaker_embedding(vid)
    mu, logvar = module.speaker_mu(z), module.speaker_logvar(z)
    if noise is None:
        noise = global_randn(mu.shape, generator, mu.device, mu.dtype)
    return mu + noise * torch.exp(0.5 * logvar), mu, logvar


class PoseGenerator(nn.Module):
    """(multimodal_context_net.py:80-179). forward(pre_seq (B, n_poses,
    pose_dim + 1): poses with the constraint bit, text (B, n_poses) int,
    audio (B, 64000), vid (B,) or None) -> (poses, z, mu, logvar); the last
    three are None without speakers. hidden_size and n_layers size both the
    TCN and the GRU, as in the reference."""

    def __init__(self, n_words, pose_dim=282, n_poses=60, n_pre_poses=10,
                 hidden_size=300, n_layers=4, dropout=0.3,
                 input_context="both", n_speakers=0, z_size=16,
                 device=None):
        super().__init__()
        self.input_context, self.hidden_size = input_context, hidden_size
        in_size = pose_dim + 1
        if input_context in ("both", "audio"):
            self.audio_encoder = WavEncoder(n_poses)
            in_size += 32
        if input_context in ("both", "text"):
            self.text_encoder = TextEncoderTCN32(
                n_words, hidden_size=hidden_size, n_layers=n_layers,
                frames=n_poses, dropout=dropout)
            in_size += 32
        self.n_speakers = n_speakers
        if n_speakers:
            add_speaker_latent(self, n_speakers, z_size)
            in_size += z_size
        self.gru = GRU(in_size, hidden_size, n_layers, bidirectional=True,
                       dropout=dropout)
        self.out = nn.Sequential(Linear(hidden_size, hidden_size // 2),
                                 LeakyReLUTrue(),
                                 Linear(hidden_size // 2, pose_dim))
        self.to(resolve_device(device))
        self.eval()

    def forward(self, pre_seq, in_text, in_audio, vid_indices=None,
                noise=None, generator=None):
        feats = [pre_seq]
        if self.input_context in ("both", "audio"):
            feats.append(self.audio_encoder(in_audio))
        if self.input_context in ("both", "text"):
            feats.append(self.text_encoder(in_text)[0])
        z = mu = logvar = None
        if self.n_speakers:
            z, mu, logvar = speaker_latent(self, vid_indices, noise,
                                           generator)
            feats.append(z[:, None].expand(-1, pre_seq.shape[1], -1))
        out, _ = self.gru(torch.cat(feats, dim=2))
        out = sum_bidirectional(out, self.hidden_size)
        return self.out(out), z, mu, logvar


class TrimodalDiscriminator(nn.Module):
    """GRU discriminator (multimodal_context_net.py:182-223): poses (B,
    n_poses, input_size) -> (B, 1) in (0, 1)."""

    def __init__(self, input_size=282, n_poses=60, hidden_size=300,
                 n_layers=4, dropout=0.3, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.gru = GRU(input_size, hidden_size, n_layers, bidirectional=True,
                       dropout=dropout)
        self.out = Linear(hidden_size, 1)
        self.out2 = Linear(n_poses, 1)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, poses):
        out, _ = self.gru(poses)
        out = self.out(sum_bidirectional(out, self.hidden_size))[..., 0]
        return torch.sigmoid(self.out2(out))


class ConvDiscriminator(nn.Module):
    """Conv + GRU discriminator (multimodal_context_net.py:226-272): three
    valid k3 convs (BatchNorm and the LeakyReLU(True) identity after the
    first two) take n_poses to n_poses - 6 frames, then a 4-layer
    bidirectional GRU, a per-frame fc and a frame-mixing fc."""

    def __init__(self, input_size=282, n_poses=60, hidden_size=64,
                 device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.pre_conv = nn.Sequential(
            Conv1d(input_size, 16, 3), BatchNorm(16), LeakyReLUTrue(),
            Conv1d(16, 8, 3), BatchNorm(8), LeakyReLUTrue(),
            Conv1d(8, 8, 3))
        self.gru = GRU(8, hidden_size, 4, bidirectional=True, dropout=0.3)
        self.out = Linear(hidden_size, 1)
        self.out2 = Linear(n_poses - 6, 1)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, poses):
        x = self.pre_conv(poses.transpose(1, 2)).transpose(1, 2)
        out, _ = self.gru(x)
        out = self.out(sum_bidirectional(out, self.hidden_size))[..., 0]
        return torch.sigmoid(self.out2(out))
