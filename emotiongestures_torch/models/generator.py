"""The co-speech gesture generator, `variant="memory"`
(port of emotiongestures_tpu/models/generator.py;
reference Full_model/Models_memory.py:426-565).

forward(spec (B, 128, T), text (B, frames) int, prior (B, prior, pose_dim),
        sampled_emotion_feature (B, frames, d_model) or None)
  -> (poses (B, frames, pose_dim), emotion_feature, semantic_feature,
      emotion_logits (B, 8), text_embedding)

Kept from the reference: unmasked attention, a decoder without
self-attention or positional encoding, post-LN, and TMMemory's coupling of
the batch (score = mem @ (mem^T @ pe) mixes the rows of a batch), so a batch
of independent samples must go through as batches of one. Under bf16 weights
`sampled (fp32) + semantic (bf16)` is fp32, so the fusion MLP, transformer and
post projector compute in fp32 with bf16 weights; the poses come out fp32,
the emotion/semantic features and logits bf16.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..core.layers import BatchNorm, Conv1d, Conv2d, Linear
from ..nn.resnet_se import ResNetSE
from ..nn.tcn import TemporalConvNet
from ..nn.transformer import TransformerDecoder, TransformerEncoder


def _mlp(d_in, d_hid, d_out, mid):
    return nn.Sequential(Linear(d_in, d_hid), mid, Linear(d_hid, d_out))


def _half_up(n: int) -> int:
    return (n + 1) // 2  # a 3x3 conv at stride 2, padding 1


class AudioResNetEncoder(nn.Module):
    """(B, n_mels, T) mel -> (B, frames, d_model)
    (Models_memory.py:92-133): 3-stage SE-ResNet, conv to `frames`
    channels, flatten freq x time per frame channel, two fcs."""

    def __init__(self, frames=60, d_model=512, n_mels=128, spec_len=124):
        super().__init__()
        self.frames = frames
        self.feat_extractor = ResNetSE((3, 4, 6), (32, 64, 128))
        self.final_conv1 = Conv2d(128, frames, 3, padding=1)
        self.bn1 = BatchNorm(frames)
        flat = _half_up(_half_up(n_mels)) * _half_up(_half_up(spec_len))
        self.fc1 = Linear(flat, d_model)
        self.dropout = nn.Dropout(0.2)
        self.fc2 = Linear(d_model, d_model)

    def forward(self, spec):
        x = self.feat_extractor(spec[:, None])
        x = self.bn1(self.final_conv1(x))
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
        self.emb_dropout = nn.Dropout(emb_dropout)
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


class SPMemoryV1(nn.Module):
    """Spatial memory v1 (Models_memory.py:215-251), vectorised: for the
    first chunk_length predicted frames, gate = sigmoid(<mem_b, pred_bc>),
    pred = gate * pred + (1 - gate) * mem."""

    def __init__(self, prior_frames, pose_dim, chunk_length=10):
        super().__init__()
        self.prior_frames, self.chunk = prior_frames, chunk_length
        self.spatial_chunk_encoder = _mlp(chunk_length * pose_dim, pose_dim,
                                          pose_dim, nn.Dropout(0.2))

    def forward(self, initial, pred):
        B = initial.shape[0]
        last = initial[:, self.prior_frames - self.chunk:].reshape(B, -1)
        mem = self.spatial_chunk_encoder(last)          # (B, D)
        head = pred[:, : self.chunk]                     # (B, C, D)
        gate = torch.sigmoid(torch.einsum("bd,bcd->bc", mem, head))[..., None]
        blended = gate * head + (1.0 - gate) * mem[:, None, :]
        return torch.cat([blended, pred[:, self.chunk:]], dim=1)


class TMMemory(nn.Module):
    """Temporal memory (Models_memory.py:263-293): score = mem @ (mem^T @ pe)
    couples the rows of the batch, as in the reference."""

    def __init__(self, prior_frames, pose_dim, chunk_length=10):
        super().__init__()
        self.prior_frames, self.chunk = prior_frames, chunk_length
        self.temporal_chunk_encoder = _mlp(chunk_length * pose_dim, pose_dim,
                                           pose_dim, nn.Dropout(0.2))
        self.temporal_memory_encoder = _mlp(chunk_length * pose_dim,
                                            chunk_length, chunk_length,
                                            nn.Dropout(0.2))

    def forward(self, initial, pred):
        B = initial.shape[0]
        last = initial[:, self.prior_frames - self.chunk:].reshape(B, -1)
        mem = self.temporal_chunk_encoder(last)              # (B, D)
        head = pred[:, : self.chunk]
        pe = self.temporal_memory_encoder(head.reshape(B, -1))  # (B, C)
        soft = torch.softmax(mem @ (mem.T @ pe), dim=1)
        rescaled = head + head * soft[..., None]
        return torch.cat([rescaled, pred[:, self.chunk:]], dim=1)


class PriorMemoryEncoder(nn.Module):
    """Seed poses -> extrapolated frames -> SP/TM memory -> d_model
    (Models_memory.py:299-345). The conv treats the frames as channels."""

    def __init__(self, prior_frames=10, frames=60, pose_dim=282, d_model=512,
                 chunk_length=10):
        super().__init__()
        pred_length = frames - prior_frames
        self.pred_conv = nn.Sequential(
            Conv1d(prior_frames, pred_length, 3, padding=1), nn.ReLU(),
            BatchNorm(pred_length),
            Conv1d(pred_length, pred_length, 3, padding=1), nn.ReLU(),
            BatchNorm(pred_length))
        self.spatial_memory = SPMemoryV1(prior_frames, pose_dim, chunk_length)
        self.temporal_memory = TMMemory(prior_frames, pose_dim, chunk_length)
        self.post_header = _mlp(pose_dim, d_model, d_model, nn.Dropout(0.2))

    def forward(self, x):  # (B, prior, pose_dim)
        pred = self.pred_conv(x)  # (B, pred_length, pose_dim)
        pred = self.spatial_memory(x, pred)
        pred = self.temporal_memory(x, pred)
        return self.post_header(torch.cat([x, pred], dim=1))


class GestureTransformer(nn.Module):
    """The full generator, variant "memory". `fused_attention=True` routes
    the eval-mode attention sublayers (3 encoder self-attention, 3 decoder
    cross-attention at the flagship depth) through `ops/fused_attention.py`.
    Built on `device` (the card unless the CPU is asked for), in eval mode."""

    def __init__(self, n_words, frames=60, pose_dim=282, prior_frames=10,
                 d_model=512, d_inner=2048, n_layers=3, n_head=8, d_k=64,
                 d_v=64, dropout=0.2, n_position=60, chunk_length=10,
                 wordembed_dim=300, text_dropout=0.1, n_emotions=8,
                 spec_len=124, fused_attention=False, device=None):
        super().__init__()
        self.text_encoder = TextEncoderTCN(n_words, wordembed_dim,
                                           frames=frames,
                                           dropout=text_dropout)
        self.audio_encoder = AudioResNetEncoder(frames, d_model,
                                                spec_len=spec_len)
        self.prior_seq_encoder = PriorMemoryEncoder(
            prior_frames, frames, pose_dim, d_model, chunk_length)
        self.emotion_proj = _mlp(d_model, d_model, d_model, nn.Dropout(0.2))
        self.semantic_proj = _mlp(d_model, d_model, d_model, nn.Dropout(0.2))
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
            Linear(d_model, d_model * 4), nn.Dropout(0.2),
            Linear(d_model * 4, d_model), nn.Dropout(0.2),
            Linear(d_model, pose_dim), nn.Dropout(0.2),
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
