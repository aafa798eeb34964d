"""Emotion-prior CVAE training (port of emotiongestures_tpu/train/cvae.py;
the reference ships no script, its interface dictates the loss):

  recon, mu, logvar = VAE(emotion_features, y_onehot)
  loss = L1(recon, features) + beta * KL(mu, logvar)

The features are a frozen generator's emotion_proj outputs
(Full_model/Models_memory.py:538; see cli/train_auxiliary.py). Only
EmotionCVAEv3 is ported; v1 and v2 are ROADMAP.md queue 1, item 7.

A step's integer key splits into a sample key (the reparameterisation's
noise) and a dropout key, as the JAX step splits its PRNG key. The CVAE's
BatchNorms train on batch statistics and write their running statistics.
"""
from __future__ import annotations

import torch

from ..core import losses, schedules
from ..core.layers import dropout_generator
from ..models.cvae import EmotionCVAEv3
from .gan import split_key
from .state import TrainState, eval_mode


def create_state(seed: int = 0, lr: float = 2e-4, version: int = 3,
                 feat_dim: int = 512, device=None) -> TrainState:
    """`feat_dim` is the generator's d_model. Adam(lr, betas (0.5, 0.999),
    no weight decay); weights drawn from torch's generator seeded with
    `seed`."""
    if version != 3:
        raise NotImplementedError(
            f"EmotionCVAEv{version} is not ported to the PyTorch port yet "
            "(ROADMAP.md queue 1, item 7); use --cvae_version 3")
    torch.manual_seed(seed)
    model = EmotionCVAEv3(feat_dim=feat_dim, device=device)
    opt = schedules.adam(model.parameters(), lr=lr, b1=0.5, b2=0.999,
                         weight_decay=0.0)
    return TrainState(model, opt)


def train_step(state: TrainState, features: torch.Tensor,
               y_onehot: torch.Tensor, rng: int, beta: float = 0.1,
               noise: torch.Tensor | None = None):
    """One update, in place, on features (B, 60, feat_dim) and one-hot
    emotions (B, 8). `noise` (B, latent_dim), for tests, replaces the
    reparameterisation's draw. Returns the state and 0-d tensors
    {"loss", "recon", "kl"}."""
    sample_key, drop_key = split_key(rng, 2)
    device = features.device
    model = state.module.train()
    with dropout_generator(model,
                           torch.Generator(device=device).manual_seed(
                               drop_key)):
        recon, mu, logvar = model(
            features, y_onehot, noise=noise,
            generator=torch.Generator(device=device).manual_seed(sample_key))
    rec = losses.l1_loss(recon, features)
    kl = losses.kl_divergence(mu, logvar)
    loss = rec + beta * kl
    state.minimize(loss)
    return state, {"loss": loss.detach(), "recon": rec.detach(),
                   "kl": kl.detach()}


def sample(state: TrainState, y_onehot: torch.Tensor, rng: int,
           noise: torch.Tensor | None = None) -> torch.Tensor:
    """Batched prior samples (B, 60, feat_dim) in eval mode."""
    gen = torch.Generator(device=y_onehot.device).manual_seed(rng)
    with eval_mode(state.module) as model:
        return model.sample(y_onehot, noise=noise, generator=gen)
