"""HA2G hierarchy baseline (port of emotiongestures_tpu/models/baselines/
hierarchy.py; reference model/hierarchy_net.py and the multi-resolution
audio encoder model/ResNetSE34V2.py:13-181): a 4-stage SE-ResNet whose
stage-2/3/4 features are pixel-shuffled, projected to 60 frames and
blended per pose level with speaker-conditioned softmax weights; a
bidirectional GRU pose generator; GRU and conv discriminators.

torch's pixel_shuffle on NCHW takes the channel index as (c, i, j), c
slowest, which is what the JAX package's channel-last pixel_shuffle
reproduces. Unlike the trimodal family, these modules use real
LeakyReLUs (slope 0.01): the reference writes LeakyReLU(inplace=True).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.device import resolve_device
from ...core.layers import BatchNorm, Conv1d, Conv2d, Linear
from ...nn.gru import GRU, sum_bidirectional
from ...nn.resnet_se import ResNetSE
from .trimodal import TextEncoderTCN32, add_speaker_latent, speaker_latent


def _half_up(n: int) -> int:
    return (n + 1) // 2


class MultiResolutionResNetSE(ResNetSE):
    """ResNetSE34V2 (model/ResNetSE34V2.py:13-181): the 4-stage SE-ResNet
    (3-4-6-3 blocks, 32-64-128-256 filters) with a head on each of stages
    2, 3 and 4 (pixel_shuffle by 1, 2, 4; a valid conv to 60 channels,
    k 2, 3, 3; ReLU; BatchNorm; a Linear over each channel's flattened map
    to n_out), and the speaker blend's layers when n_speakers > 0."""

    def __init__(self, n_out=32, pose_level=3, n_speakers=0, n_mels=128,
                 spec_len=124):
        super().__init__((3, 4, 6, 3), (32, 64, 128, 256))
        h2, w2 = _half_up(n_mels), _half_up(spec_len)
        h3, w3 = _half_up(h2), _half_up(w2)
        h4, w4 = _half_up(h3), _half_up(w3)
        heads = {"low": (64, 1, 2, h2, w2), "mid": (128, 2, 3, h3, w3),
                 "high": (256, 4, 3, h4, w4)}
        self.shuffle = {}
        for name, (ch, r, k, h, w) in heads.items():
            setattr(self, f"conv_{name}", Conv2d(ch // (r * r), 60, k))
            setattr(self, f"bn_{name}", BatchNorm(60))
            flat = (h * r - k + 1) * (w * r - k + 1)
            setattr(self, f"fc_{name}", Linear(flat, n_out))
            self.shuffle[name] = r
        self.pose_level = pose_level
        if n_speakers:
            self.speaker_embedding = nn.Sequential(
                nn.Embedding(n_speakers, 16), Linear(16, 16), nn.ELU())
            nn.init.normal_(self.speaker_embedding[0].weight, std=1.0)
            self.fc1 = Linear(16, 32)
            self.fc2 = Linear(32, pose_level * 3)
        self.n_speakers = n_speakers

    def head(self, name, f):
        r = self.shuffle[name]
        if r > 1:
            f = F.pixel_shuffle(f, r)
        f = getattr(self, f"bn_{name}")(torch.relu(
            getattr(self, f"conv_{name}")(f)))
        return getattr(self, f"fc_{name}")(f.flatten(2))

    def forward(self, spec, vid_indices=None):
        x = self.bn1(torch.relu(self.conv1(spec[:, None])))
        feats = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            feats.append(x)
        low = self.head("low", feats[1])
        mid = self.head("mid", feats[2])
        high = self.head("high", feats[3])
        weight, blended = None, []
        if self.n_speakers:
            z = F.elu(self.fc1(self.speaker_embedding(vid_indices)))
            w = self.fc2(z).view(z.shape[0], 3, self.pose_level)
            weight = torch.softmax(w, dim=1)
            for i in range(self.pose_level):
                blended.append(low * weight[:, 0, i, None, None]
                               + mid * weight[:, 1, i, None, None]
                               + high * weight[:, 2, i, None, None])
        return weight, low, mid, high, blended


class HierarchicalWavEncoder(nn.Module):
    """(hierarchy_net.py:17-26): mel (B, n_mels, T), speaker ids or None ->
    (weight (B, 3, pose_level) or None, low, mid, high (B, 60, n_out), the
    pose_level blended features)."""

    def __init__(self, n_out=32, pose_level=3, n_speakers=0, n_mels=128,
                 spec_len=124, device=None):
        super().__init__()
        self.feat_extractor = MultiResolutionResNetSE(
            n_out, pose_level, n_speakers, n_mels, spec_len)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, spec, vid_indices=None):
        return self.feat_extractor(spec, vid_indices)


class HierarchicalPoseGenerator(nn.Module):
    """(hierarchy_net.py:68-163): pre_seq (B, n_poses, pose_dim + 1) ⊕ a
    blended audio feature (B, n_poses, audio_dim) ⊕ the TCN text feature
    (⊕ the speaker z) -> bidirectional GRU -> Linear -> LeakyReLU(0.01) ->
    Linear. Returns (poses, z, mu, logvar). hidden_size and n_layers size
    both the TCN and the GRU, as in the reference."""

    def __init__(self, n_words, pose_dim=282, n_poses=60, n_pre_poses=10,
                 hidden_size=300, n_layers=4, dropout=0.3,
                 input_context="both", n_speakers=0, z_size=16,
                 word_embed_size=300, audio_dim=32, device=None):
        super().__init__()
        self.input_context, self.hidden_size = input_context, hidden_size
        self.text_encoder = TextEncoderTCN32(
            n_words, embed_size=word_embed_size, hidden_size=hidden_size,
            n_layers=n_layers, frames=n_poses, dropout=dropout)
        in_size = pose_dim + 1 + {"both": audio_dim + 32, "audio": audio_dim,
                                  "text": 32}.get(input_context, 0)
        self.n_speakers = n_speakers
        if n_speakers:
            add_speaker_latent(self, n_speakers, z_size)
            in_size += z_size
        self.gru = GRU(in_size, hidden_size, n_layers, bidirectional=True,
                       dropout=dropout)
        self.out = nn.Sequential(Linear(hidden_size, hidden_size // 2),
                                 nn.LeakyReLU(),
                                 Linear(hidden_size // 2, pose_dim))
        self.to(resolve_device(device))
        self.eval()

    def forward(self, pre_seq, in_text, audio_feat_seq, vid_indices=None,
                noise=None, generator=None):
        text_feat, _ = self.text_encoder(in_text)
        feats = [pre_seq]
        if self.input_context in ("both", "audio"):
            feats.append(audio_feat_seq)
        if self.input_context in ("both", "text"):
            feats.append(text_feat)
        z = mu = logvar = None
        if self.n_speakers:
            z, mu, logvar = speaker_latent(self, vid_indices, noise,
                                           generator)
            feats.append(z[:, None].expand(-1, pre_seq.shape[1], -1))
        out, _ = self.gru(torch.cat(feats, dim=2))
        out = sum_bidirectional(out, self.hidden_size)
        return self.out(out), z, mu, logvar


class HierarchicalDiscriminator(nn.Module):
    """GRU pose discriminator (hierarchy_net.py:166-208), without the text
    branch: the reference's calls TextEncoderTCN with shifted arguments and
    cannot run. poses (B, n_poses, input_size) -> (B, 1) in (0, 1)."""

    def __init__(self, input_size=282, hidden_size=300, n_layers=4,
                 n_poses=60, dropout=0.3, device=None):
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


class HierarchicalConvDiscriminator(nn.Module):
    """Conv pose discriminator (hierarchy_net.py:211-255): three valid k3
    convs (BatchNorm and LeakyReLU(0.01) after the first two; n_poses to
    n_poses - 6 frames), a 4-layer bidirectional GRU, a per-frame fc, a
    frame-mixing fc and a sigmoid."""

    def __init__(self, input_size=282, n_poses=60, hidden_size=64,
                 device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.pre_conv = nn.Sequential(
            Conv1d(input_size, 16, 3), BatchNorm(16), nn.LeakyReLU(),
            Conv1d(16, 8, 3), BatchNorm(8), nn.LeakyReLU(),
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
