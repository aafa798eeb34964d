"""FGD feature autoencoder (port of emotiongestures_tpu/models/fgd_ae.py;
reference model/FGD.py:26-82 MLP_Reconstruct): a per-frame MLP autoencoder
over 282-d poses; the 512-d latent is the FGD feature space. Attribute names
are the reference's (`Encoder`/`Decoder` Sequentials, Dropout at the odd
indices), so its state_dicts load as they are. Dropout acts only in
training, with flax's keep rule, and draws from the generator that
`core.layers.dropout_generator` sets; the module is built in eval mode.
"""
from __future__ import annotations

import torch.nn as nn

from ..core.device import resolve_device
from ..core.layers import Dropout, Linear


class FGDAutoEncoder(nn.Module):
    def __init__(self, pose_dim: int = 282, latent_dim: int = 512,
                 device=None):
        super().__init__()
        self.Encoder = nn.Sequential(
            Linear(pose_dim, latent_dim), Dropout(0.2),
            Linear(latent_dim, latent_dim), Dropout(0.2),
            Linear(latent_dim, latent_dim))
        self.Decoder = nn.Sequential(
            Linear(latent_dim, latent_dim), Dropout(0.2),
            Linear(latent_dim, latent_dim), Dropout(0.2),
            Linear(latent_dim, pose_dim))
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x):
        """(..., pose_dim) -> (reconstruction, latent (..., latent_dim))."""
        latent = self.Encoder(x)
        return self.Decoder(latent), latent
