"""The co-speech gesture generator and its prior-encoder variants
(port of emotiongestures_tpu/models/generator.py; reference
Full_model/Models_memory.py:426-565 and its three near-copies):

  variant="memory"          Models_memory.Transformer: SPMemoryV1 + TMMemory
  variant="base"            Models.Transformer: PriorConvEncoder
  variant="spatial_memory"  Models_spatial_memory: SPMemoryV2, no TMMemory
  variant="padding_initial" Models_padding_initial: SPMemoryV2 + TMMemory

The switch is the JAX package's (its models/generator.py:402-415), which
keeps TMMemory in `padding_initial`.

forward(spec (B, 128, T), text (B, frames) int, prior (B, prior, pose_dim),
        sampled_emotion_feature (B, frames, d_model) or None)
  -> (poses (B, frames, pose_dim), emotion_feature, semantic_feature,
      emotion_logits (B, 8), text_embedding)

Kept from the reference: unmasked attention, a decoder without
self-attention or positional encoding, post-LN, and TMMemory's coupling of
the batch (score = mem @ (mem^T @ pe) mixes the rows of a batch), so a batch
of independent samples must go through as batches of one. Under data
parallelism the batch is the global one: mem^T @ pe is a sum over the rows,
taken on every rank and summed over the ranks (parallel/mesh.py), in train
and in eval, so the coupling holds across ranks as GSPMD keeps it in the
JAX package. Under bf16 weights
`sampled (fp32) + semantic (bf16)` is fp32, so the fusion MLP, transformer and
post projector compute in fp32 with bf16 weights; the poses come out fp32,
the emotion/semantic features and logits bf16.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.layers import BatchNorm, Conv1d, Conv2d, Dropout, Linear
from ..nn.resnet_se import ResNetSE
from ..nn.tcn import TemporalConvNet
from ..nn.transformer import TransformerDecoder, TransformerEncoder
from ..parallel import mesh


def _mlp(d_in, d_hid, d_out, mid):
    return nn.Sequential(Linear(d_in, d_hid), mid, Linear(d_hid, d_out))


def _half_up(n: int) -> int:
    return (n + 1) // 2  # a 3x3 conv at stride 2, padding 1


class AudioResNetEncoder(nn.Module):
    """(B, n_mels, T) mel -> (B, frames, d_model)
    (Models_memory.py:92-133): 3-stage SE-ResNet, conv to `frames`
    channels, flatten freq x time per frame channel, two fcs."""

    def __init__(self, frames=60, d_model=512, n_mels=128, spec_len=124,
                 remat_blocks=False):
        super().__init__()
        self.frames = frames
        self.feat_extractor = ResNetSE((3, 4, 6), (32, 64, 128),
                                       remat_blocks=remat_blocks)
        self.final_conv1 = Conv2d(128, frames, 3, padding=1)
        self.bn1 = BatchNorm(frames)
        flat = _half_up(_half_up(n_mels)) * _half_up(_half_up(spec_len))
        self.fc1 = Linear(flat, d_model)
        self.dropout = Dropout(0.2)
        self.fc2 = Linear(d_model, d_model)

    def forward(self, spec):
        x = self.feat_extractor(spec[:, None])
        x = self.bn1(self.final_conv1(x))
        x = x.reshape(x.shape[0], self.frames, -1)
        return self.fc2(self.dropout(self.fc1(x)))


class AudioConvEncoder(nn.Module):
    """The lighter 2-conv audio encoder (Models_memory.py:59-89), which no
    variant uses: (B, n_mels, T) -> (B, frames, d_model). Each conv is
    conv3x3 -> relu -> BatchNorm -> 3x3 max pool at stride 2, padding 1.

    The JAX package has no weight table for it; its names (`conv1`, `bn1`,
    `conv2`, `bn2`, `fc1`, `fc2`) are the JAX module's, in the style of
    AudioResNetEncoder's reference names. Loading a reference `.pth` into
    it is unverified: the reference tree was not at hand to check them."""

    def __init__(self, frames=60, d_model=512, n_mels=128, spec_len=124):
        super().__init__()
        self.frames = frames
        self.conv1 = Conv2d(1, frames, 3, padding=1)
        self.bn1 = BatchNorm(frames)
        self.conv2 = Conv2d(frames, frames, 3, padding=1)
        self.bn2 = BatchNorm(frames)
        flat = _half_up(_half_up(n_mels)) * _half_up(_half_up(spec_len))
        self.fc1 = Linear(flat, d_model)
        self.dropout = Dropout(0.2)
        self.fc2 = Linear(d_model, d_model)

    def forward(self, spec):
        x = spec[:, None]
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = F.max_pool2d(bn(torch.relu(conv(x))), 3, stride=2,
                             padding=1)
        x = x.reshape(x.shape[0], self.frames, -1)
        return self.fc2(self.dropout(self.fc1(x)))


class TextEncoderTCN(nn.Module):
    """Word indices (B, frames) -> (B, frames, 512) (Models_memory.py:143-179):
    embedding -> TCN -> fc over the TIME axis -> linear to 512."""

    def __init__(self, n_words, embed_size=300, hidden_size=300, n_layers=3,
                 frames=60, kernel_size=2, dropout=0.1, emb_dropout=0.1):
        super().__init__()
        self.embedding = nn.Embedding(n_words, embed_size)
        nn.init.normal_(self.embedding.weight, std=1.0)
        self.emb_dropout = Dropout(emb_dropout)
        self.tcn = TemporalConvNet(embed_size, [hidden_size] * n_layers,
                                   kernel_size, dropout)
        self.fc1 = nn.Sequential(Linear(frames, frames))
        self.decoder = Linear(hidden_size, 512)
        nn.init.normal_(self.decoder.weight, std=0.01)

    def forward(self, tokens):
        emb = self.emb_dropout(self.embedding(tokens))  # (B, L, E)
        y = self.tcn(emb.transpose(1, 2))                # (B, hidden, L)
        y = self.fc1(y).transpose(1, 2)                  # fc over time
        return self.decoder(y)


class PriorConvEncoder(nn.Module):
    """Seed poses (B, prior_frames, pose_dim) -> (B, frames, d_model), the
    `base` variant's prior encoder (Full_model/Models.py:184-212): two
    frame-channel convs over pose_dim, each conv -> relu -> BatchNorm, then
    fc1 -> dropout -> fc2 over pose_dim.

    The JAX package has no weight table for it; its names (`conv1`, `bn1`,
    `conv2`, `bn2`, `fc1`, `fc2`) are the JAX module's. Loading a reference
    `.pth` into it is unverified: the reference tree was not at hand to
    check them."""

    def __init__(self, prior_frames=10, frames=60, pose_dim=282,
                 d_model=512):
        super().__init__()
        self.conv1 = Conv1d(prior_frames, frames, 3, padding=1)
        self.bn1 = BatchNorm(frames)
        self.conv2 = Conv1d(frames, frames, 3, padding=1)
        self.bn2 = BatchNorm(frames)
        self.fc1 = Linear(pose_dim, d_model)
        self.dropout = Dropout(0.2)
        self.fc2 = Linear(d_model, d_model)

    def forward(self, x):
        x = self.bn1(torch.relu(self.conv1(x)))
        x = self.bn2(torch.relu(self.conv2(x)))
        return self.fc2(self.dropout(self.fc1(x)))


class SPMemoryV1(nn.Module):
    """Spatial memory v1 (Models_memory.py:215-251), vectorised: for the
    first chunk_length predicted frames, gate = sigmoid(<mem_b, pred_bc>),
    pred = gate * pred + (1 - gate) * mem."""

    def __init__(self, prior_frames, pose_dim, chunk_length=10):
        super().__init__()
        self.prior_frames, self.chunk = prior_frames, chunk_length
        self.spatial_chunk_encoder = _mlp(chunk_length * pose_dim, pose_dim,
                                          pose_dim, Dropout(0.2))

    def forward(self, initial, pred):
        B = initial.shape[0]
        last = initial[:, self.prior_frames - self.chunk:].reshape(B, -1)
        mem = self.spatial_chunk_encoder(last)          # (B, D)
        head = pred[:, : self.chunk]                     # (B, C, D)
        gate = torch.sigmoid(torch.einsum("bd,bcd->bc", mem, head))[..., None]
        blended = gate * head + (1.0 - gate) * mem[:, None, :]
        return torch.cat([blended, pred[:, self.chunk:]], dim=1)


class SPMemoryV2(nn.Module):
    """Spatial memory v2 (Full_model/Models_spatial_memory.py:255-295). The
    reference blends into a clone of the predicted frames and returns the
    original, so v2 changes nothing and its parameters get no gradient.
    Its conv encoder over the last chunk (chunk -> 1 -> 1 frame channels,
    each conv -> relu -> BatchNorm) still runs in train mode, where its
    BatchNorms take batch statistics and write their running statistics,
    as the JAX step writes them; in eval mode it has no effect and is
    skipped.

    The JAX package has no weight table for it; its names (`conv1`, `bn1`,
    `conv2`, `bn2`) are the JAX module's. Loading a reference `.pth` into
    it is unverified: the reference tree was not at hand to check them."""

    def __init__(self, prior_frames, pose_dim, chunk_length=10):
        super().__init__()
        self.prior_frames, self.chunk = prior_frames, chunk_length
        self.conv1 = Conv1d(chunk_length, 1, 3, padding=1)
        self.bn1 = BatchNorm(1)
        self.conv2 = Conv1d(1, 1, 3, padding=1)
        self.bn2 = BatchNorm(1)

    def forward(self, initial, pred):
        if self.training:
            h = initial[:, self.prior_frames - self.chunk:]
            h = self.bn1(torch.relu(self.conv1(h)))
            self.bn2(torch.relu(self.conv2(h)))
        return pred


def batch_coupling(mem: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """mem^T @ pe (D, C), a sum over the rows of the global batch: under
    data parallelism each rank's product in fp32, summed over the ranks in
    one differentiable all-reduce and cast back to the product's type."""
    if not mesh.active():
        return mem.T @ pe
    part = mem.T.float() @ pe.float()
    return mesh.all_reduce_sum(part).to(torch.promote_types(mem.dtype,
                                                            pe.dtype))


class TMMemory(nn.Module):
    """Temporal memory (Models_memory.py:263-293): score = mem @ (mem^T @ pe)
    couples the rows of the batch, as in the reference (`batch_coupling`)."""

    def __init__(self, prior_frames, pose_dim, chunk_length=10):
        super().__init__()
        self.prior_frames, self.chunk = prior_frames, chunk_length
        self.temporal_chunk_encoder = _mlp(chunk_length * pose_dim, pose_dim,
                                           pose_dim, Dropout(0.2))
        self.temporal_memory_encoder = _mlp(chunk_length * pose_dim,
                                            chunk_length, chunk_length,
                                            Dropout(0.2))

    def forward(self, initial, pred):
        B = initial.shape[0]
        last = initial[:, self.prior_frames - self.chunk:].reshape(B, -1)
        mem = self.temporal_chunk_encoder(last)              # (B, D)
        head = pred[:, : self.chunk]
        pe = self.temporal_memory_encoder(head.reshape(B, -1))  # (B, C)
        soft = torch.softmax(mem @ batch_coupling(mem, pe), dim=1)
        rescaled = head + head * soft[..., None]
        return torch.cat([rescaled, pred[:, self.chunk:]], dim=1)


class PriorMemoryEncoder(nn.Module):
    """Seed poses -> extrapolated frames -> SP/TM memory -> d_model
    (Models_memory.py:299-345). The conv treats the frames as channels.
    `spatial_v2` takes SPMemoryV2 in place of SPMemoryV1; `temporal=False`
    leaves TMMemory out."""

    def __init__(self, prior_frames=10, frames=60, pose_dim=282, d_model=512,
                 chunk_length=10, spatial_v2=False, temporal=True):
        super().__init__()
        pred_length = frames - prior_frames
        self.pred_conv = nn.Sequential(
            Conv1d(prior_frames, pred_length, 3, padding=1), nn.ReLU(),
            BatchNorm(pred_length),
            Conv1d(pred_length, pred_length, 3, padding=1), nn.ReLU(),
            BatchNorm(pred_length))
        spatial = SPMemoryV2 if spatial_v2 else SPMemoryV1
        self.spatial_memory = spatial(prior_frames, pose_dim, chunk_length)
        self.temporal_memory = (TMMemory(prior_frames, pose_dim, chunk_length)
                                if temporal else None)
        self.post_header = _mlp(pose_dim, d_model, d_model, Dropout(0.2))

    def forward(self, x):  # (B, prior, pose_dim)
        pred = self.pred_conv(x)  # (B, pred_length, pose_dim)
        pred = self.spatial_memory(x, pred)
        if self.temporal_memory is not None:
            pred = self.temporal_memory(x, pred)
        return self.post_header(torch.cat([x, pred], dim=1))


VARIANTS = ("memory", "base", "spatial_memory", "padding_initial")


class GestureTransformer(nn.Module):
    """The full generator. `variant` picks the prior encoder (the module
    docstring); the rest is the same in all four. `fused_attention=True` routes
    the eval-mode attention sublayers (3 encoder self-attention, 3 decoder
    cross-attention at the flagship depth) through `ops/fused_attention.py`.
    Built on `device` (the card unless the CPU is asked for), in eval mode.

    After `.train()` it is the JAX generator's `train=True`: BatchNorm on
    batch statistics (core/layers.py), dropout drawn from the generator
    that `core.layers.dropout_generator` sets, attention on the einsum path,
    and the same 5-tuple. `remat_audio=True` checkpoints each SE block of
    the audio encoder (the JAX `remat_audio`)."""

    def __init__(self, n_words, frames=60, pose_dim=282, prior_frames=10,
                 d_model=512, d_inner=2048, n_layers=3, n_head=8, d_k=64,
                 d_v=64, dropout=0.2, n_position=60, chunk_length=10,
                 wordembed_dim=300, text_dropout=0.1, n_emotions=8,
                 spec_len=124, fused_attention=False, remat_audio=False,
                 variant="memory", device=None):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown generator variant {variant!r}; one "
                             f"of {VARIANTS}")
        self.variant = variant
        self.text_encoder = TextEncoderTCN(n_words, wordembed_dim,
                                           frames=frames,
                                           dropout=text_dropout)
        self.audio_encoder = AudioResNetEncoder(frames, d_model,
                                                spec_len=spec_len,
                                                remat_blocks=remat_audio)
        if variant == "base":
            self.prior_seq_encoder = PriorConvEncoder(prior_frames, frames,
                                                      pose_dim, d_model)
        else:
            self.prior_seq_encoder = PriorMemoryEncoder(
                prior_frames, frames, pose_dim, d_model, chunk_length,
                spatial_v2=variant in ("spatial_memory", "padding_initial"),
                temporal=variant in ("memory", "padding_initial"))
        self.emotion_proj = _mlp(d_model, d_model, d_model, Dropout(0.2))
        self.semantic_proj = _mlp(d_model, d_model, d_model, Dropout(0.2))
        self.fusion_proj = _mlp(d_model, d_model, d_model, nn.ReLU())
        self.emotion_classifer_header = nn.Sequential(
            Linear(frames * d_model, d_model), nn.ReLU(),
            Linear(d_model, 256), nn.ReLU(), Linear(256, 64), nn.ReLU(),
            Linear(64, n_emotions))
        self.encoder = TransformerEncoder(
            n_layers, n_head, d_k, d_v, d_model, d_inner, dropout,
            n_position, fused=fused_attention)
        self.decoder = TransformerDecoder(
            n_layers, n_head, d_k, d_v, d_model, d_inner, dropout,
            fused=fused_attention)
        self.post_projector = nn.Sequential(
            Linear(d_model, d_model * 4), Dropout(0.2),
            Linear(d_model * 4, d_model), Dropout(0.2),
            Linear(d_model, pose_dim), Dropout(0.2),
            Linear(pose_dim, pose_dim))
        self.to(resolve_device(device))
        self.eval()

    def forward(self, spec, text, prior_seq, sampled_emotion_feature=None):
        text_embedding = self.text_encoder(text)
        spectrum_feature = self.audio_encoder(spec)
        prior = self.prior_seq_encoder(prior_seq)
        emotion_feature = self.emotion_proj(spectrum_feature)
        semantic_feature = self.semantic_proj(spectrum_feature)
        emotion_prediction = self.emotion_classifer_header(
            emotion_feature.flatten(1))
        if sampled_emotion_feature is not None:
            fusion = sampled_emotion_feature + semantic_feature
        else:
            fusion = emotion_feature + semantic_feature
        enc_output = self.encoder(self.fusion_proj(fusion))
        dec_output = self.decoder(prior, enc_output)
        poses = self.post_projector(dec_output)
        return (poses, emotion_feature, semantic_feature, emotion_prediction,
                text_embedding)


def set_pretrained_embedding(module: GestureTransformer, weights):
    """Install fasttext-exported word vectors, an (n_words, 300) matrix
    such as `convert_data wordvec` writes, as the text encoder's embedding
    (TextEncoderTCN, Models_memory.py:149-153): fp32, on the module's
    device, in the same Parameter. Returns the module."""
    emb = module.text_encoder.embedding
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32)
    with torch.no_grad():
        emb.weight.data = w.to(emb.weight.device)
    emb.num_embeddings = w.shape[0]
    return module
