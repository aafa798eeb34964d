"""Skeleton emotion classifier (port of
emotiongestures_tpu/models/skeleton_classifier.py; reference
skeleton_classifer/Models.py:199-283): pose sequence (B, 60, 282) ->
per-frame fc encoder -> 3-layer transformer encoder -> flatten -> MLP head ->
8 logits, with the encoder output returned as `mid_feature`.

Attribute names follow the reference (`prior_seq_encoder.fc1/fc2`,
`encoder.layer_stack`, `post_projector` with Linears at 0, 2, 4, 6, 8). The
reference encoder's position_embeddings and trailing layer_norm are unused in
its forward, so they are not built; `utils.weights.load_reference_state`
drops them from a reference checkpoint. Fused attention stays off, as in the
JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..core.layers import Dropout, Linear
from ..nn.transformer import TransformerEncoder


class _PriorEncoder(nn.Module):
    """Prior_Encoder (skeleton_classifer/Models.py:88-116)."""

    def __init__(self, pose_dim: int, d_model: int):
        super().__init__()
        self.fc1 = Linear(pose_dim, d_model)
        self.dropout = Dropout(0.2)
        self.fc2 = Linear(d_model, d_model)

    def forward(self, x):
        return self.fc2(self.dropout(self.fc1(x)))


class SkeletonTransformer(nn.Module):
    def __init__(self, class_dim: int = 8, pose_dim: int = 282,
                 d_model: int = 512, d_inner: int = 2048, n_layers: int = 3,
                 n_head: int = 8, d_k: int = 64, d_v: int = 64,
                 dropout: float = 0.2, n_position: int = 60, device=None):
        super().__init__()
        self.prior_seq_encoder = _PriorEncoder(pose_dim, d_model)
        self.encoder = TransformerEncoder(n_layers, n_head, d_k, d_v, d_model,
                                          d_inner, dropout, n_position)
        self.post_projector = nn.Sequential(
            Linear(n_position * d_model, d_model * 4), nn.ReLU(),
            Linear(d_model * 4, d_model), nn.ReLU(),
            Linear(d_model, 128), nn.ReLU(),
            Linear(128, 64), nn.ReLU(),
            Linear(64, class_dim))
        self.to(resolve_device(device))
        self.eval()

    def forward(self, pose_seq: torch.Tensor):
        """(B, n_position, pose_dim) -> (logits (B, class_dim),
        mid_feature (B, n_position, d_model))."""
        mid_feature = self.encoder(self.prior_seq_encoder(pose_seq))
        return self.post_projector(mid_feature.flatten(1)), mid_feature
