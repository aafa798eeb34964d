"""The trimodal FGD feature net (port of
emotiongestures_tpu/models/baselines/embedding_net.py; reference
model/embedding_net.py): a conv pose VAE encoder, FC / GRU / conv pose
decoders and a text + audio context encoder. Poses are (B, T, D).

Names. PoseEncoderConv, PoseDecoderConv and EmbeddingNet in `pose` mode
keep the names of the JAX package's tables (utils/torch_port.py). The JAX
package has no table for the rest, so the port chose these, after the
reference's habit of Sequentials named `pre_pose_net`, `net` and `out`:
PoseDecoderFC (`pre_pose_net`, `net`), PoseDecoderGRU (`pre_pose_net`,
`gru`, `out`), ContextEncoder (`text_encoder`, `audio_encoder`, `gru`,
`out`, `fc_mu`, `fc_logvar`), the pre-pose branch of PoseDecoderConv
(`pre_pose_net`) and so EmbeddingNet in `speech` mode. Loading a reference
`.pth` into those is unverified: the reference tree was not at hand.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ...core.device import resolve_device
from ...core.layers import BatchNorm, Linear
from ...nn.gru import GRU, sum_bidirectional
from ...parallel.mesh import global_randn
from .motion_ae import PoseConvNet, deconv_net
from .quirks import LeakyReLUTrue
from .trimodal import TextEncoderTCN32, WavEncoder


def _reparameterize(mu, logvar, noise, generator):
    if noise is None:
        noise = global_randn(mu.shape, generator, mu.device, mu.dtype)
    return mu + noise * torch.exp(0.5 * logvar)


def _pre_pose_net(n_pre_poses, pose_dim):
    """Linear(n_pre * D, 32) -> BatchNorm -> ReLU -> Linear(32, 32) over the
    flattened seed poses."""
    return nn.Sequential(Linear(n_pre_poses * pose_dim, 32), BatchNorm(32),
                         nn.ReLU(), Linear(32, 32))


class PoseEncoderConv(PoseConvNet):
    """(embedding_net.py:42-83): poses (B, length, pose_dim) -> (z, mu,
    logvar). z is mu unless `variational_encoding`, then mu + noise *
    exp(logvar / 2). The reference hard-codes the out_net's fan-in for 60
    frames; here it follows `length`, as the JAX package's inferred one
    does."""

    def __init__(self, length, pose_dim, latent_dim=32):
        super().__init__(length, pose_dim, latent_dim)
        self.fc_mu = Linear(latent_dim, latent_dim)
        self.fc_logvar = Linear(latent_dim, latent_dim)

    def forward(self, poses, variational_encoding=False, noise=None,
                generator=None):
        x = super().forward(poses)
        mu, logvar = self.fc_mu(x), self.fc_logvar(x)
        z = (_reparameterize(mu, logvar, noise, generator)
             if variational_encoding else mu)
        return z, mu, logvar


class PoseDecoderFC(nn.Module):
    """(embedding_net.py:86-128): latent (B, 32) [+ the seed poses' 32-d
    code] -> 128 -> 128 -> 256 -> 512 (each Linear -> BatchNorm -> ReLU) ->
    (B, gen_length, pose_dim)."""

    def __init__(self, gen_length, pose_dim, latent_dim=32,
                 use_pre_poses=False, n_pre_poses=4):
        super().__init__()
        self.gen_length, self.pose_dim = gen_length, pose_dim
        self.use_pre_poses = use_pre_poses
        d = latent_dim
        if use_pre_poses:
            self.pre_pose_net = _pre_pose_net(n_pre_poses, pose_dim)
            d += 32
        layers = []
        for f in (128, 128, 256, 512):
            layers += [Linear(d, f), BatchNorm(f), nn.ReLU()]
            d = f
        layers.append(Linear(d, gen_length * pose_dim))
        self.net = nn.Sequential(*layers)

    def forward(self, latent_code, pre_poses=None):
        feat = latent_code
        if self.use_pre_poses:
            feat = torch.cat([self.pre_pose_net(pre_poses.flatten(1)), feat],
                             dim=1)
        return self.net(feat).view(-1, self.gen_length, self.pose_dim)


class PoseDecoderGRU(nn.Module):
    """(embedding_net.py:131-163): the seed poses' 32-d code ⊕ latent,
    repeated over gen_length frames, through a 4-layer bidirectional GRU
    (dropout 0.3), summed directions, Linear -> LeakyReLU(True) -> Linear."""

    def __init__(self, gen_length, pose_dim, latent_dim=32, hidden_size=300,
                 n_pre_poses=4):
        super().__init__()
        self.gen_length, self.hidden_size = gen_length, hidden_size
        self.pre_pose_net = _pre_pose_net(n_pre_poses, pose_dim)
        self.gru = GRU(32 + latent_dim, hidden_size, 4, bidirectional=True,
                       dropout=0.3)
        self.out = nn.Sequential(Linear(hidden_size, hidden_size // 2),
                                 LeakyReLUTrue(),
                                 Linear(hidden_size // 2, pose_dim))

    def forward(self, latent_code, pre_poses):
        feat = torch.cat([self.pre_pose_net(pre_poses.flatten(1)),
                          latent_code], dim=1)
        feat = feat[:, None].expand(-1, self.gen_length, -1)
        out, _ = self.gru(feat)
        return self.out(sum_bidirectional(out, self.hidden_size))


class PoseDecoderConv(nn.Module):
    """(embedding_net.py:166-218): latent [+ the seed poses' code] ->
    pre_net (Linear -> BatchNorm -> LeakyReLU(True) -> Linear) -> (B, 4, L)
    -> the transposed-conv tail -> (B, length, pose_dim). Its widths are
    (64, 136) for length 34, (128, 256) for 64, and the JAX package's
    generalisation (64, 4 (length + 6)) otherwise."""

    def __init__(self, length, pose_dim, latent_dim=32, use_pre_poses=False,
                 n_pre_poses=4):
        super().__init__()
        self.use_pre_poses = use_pre_poses
        d = latent_dim
        if use_pre_poses:
            self.pre_pose_net = _pre_pose_net(n_pre_poses, pose_dim)
            d += 32
        if length == 64:
            hidden = 128, 256
        elif length == 34:
            hidden = 64, 136
        else:
            hidden = 64, 4 * ((length + 6) if length > 8 else 8)
        self.pre_net = nn.Sequential(Linear(d, hidden[0]),
                                     BatchNorm(hidden[0]), LeakyReLUTrue(),
                                     Linear(hidden[0], hidden[1]))
        self.net = deconv_net(pose_dim)

    def forward(self, feat, pre_poses=None):
        if self.use_pre_poses:
            feat = torch.cat([self.pre_pose_net(pre_poses.flatten(1)), feat],
                             dim=1)
        x = self.pre_net(feat).view(feat.shape[0], 4, -1)
        return self.net(x).transpose(1, 2)


class ContextEncoder(nn.Module):
    """(embedding_net.py:221-260): the 32-d TCN text features ⊕ the wave
    encoder's, a 2-layer GRU (256), its last step through Linear(128) ->
    BatchNorm -> ReLU -> Linear(32), then mu / logvar and z = mu + noise *
    exp(logvar / 2) (always variational, as in the reference)."""

    def __init__(self, n_words, n_frames=34):
        super().__init__()
        self.text_encoder = TextEncoderTCN32(n_words, frames=n_frames)
        self.audio_encoder = WavEncoder(n_frames)
        self.gru = GRU(64, 256, 2)
        self.out = nn.Sequential(Linear(256, 128), BatchNorm(128), nn.ReLU(),
                                 Linear(128, 32))
        self.fc_mu = Linear(32, 32)
        self.fc_logvar = Linear(32, 32)

    def forward(self, in_text, in_audio, noise=None, generator=None):
        text_feat, _ = self.text_encoder(in_text)
        x = torch.cat([self.audio_encoder(in_audio), text_feat], dim=2)
        out, _ = self.gru(x)
        last = self.out(out[:, -1])
        mu, logvar = self.fc_mu(last), self.fc_logvar(last)
        return _reparameterize(mu, logvar, noise, generator), mu, logvar


class EmbeddingNet(nn.Module):
    """(embedding_net.py:263-316). mode "pose": the pose VAE encoder and the
    conv decoder, no context encoder; otherwise the context encoder and the
    GRU decoder as well. forward(in_text, in_audio, pre_poses, poses,
    input_mode=None, variational_encoding=False) -> (context z, mu, logvar,
    pose z, mu, logvar, decoded poses); the context entries are None
    without a context encoder or its inputs. `context_noise` and
    `pose_noise` stand in for the two N(0, I) draws."""

    def __init__(self, n_words, pose_dim, n_frames, mode="pose",
                 n_pre_poses=4, device=None):
        super().__init__()
        self.mode = mode
        if mode != "pose":
            self.context_encoder = ContextEncoder(n_words, n_frames)
            self.decoder = PoseDecoderGRU(n_frames, pose_dim,
                                          n_pre_poses=n_pre_poses)
        else:
            self.context_encoder = None
            self.decoder = PoseDecoderConv(n_frames, pose_dim)
        self.pose_encoder = PoseEncoderConv(n_frames, pose_dim)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, in_text, in_audio, pre_poses, poses, input_mode=None,
                variational_encoding=False, context_noise=None,
                pose_noise=None, generator=None):
        input_mode = input_mode or self.mode
        context = (None, None, None)
        if self.context_encoder is not None and in_text is not None \
                and in_audio is not None:
            context = self.context_encoder(in_text, in_audio, context_noise,
                                           generator)
        pose = self.pose_encoder(poses, variational_encoding, pose_noise,
                                 generator)
        latent = context[0] if input_mode == "speech" else pose[0]
        return (*context, *pose, self.decoder(latent, pre_poses))
