"""FGD feature-autoencoder training (port of emotiongestures_tpu/train/fgd.py;
reference model/FGD.py): L1 reconstruction of pose windows with dropout on;
the 512-d latent becomes the FGD feature space.

A step's dropout comes from a torch.Generator seeded with its integer key
(`train.gan.step_key(seed, global step)` in the trainer CLI).
"""
from __future__ import annotations

import torch

from ..core import losses, schedules
from ..core.layers import dropout_generator
from ..models.fgd_ae import FGDAutoEncoder
from ..parallel import mesh
from .state import TrainState, eval_mode


def create_state(seed: int = 0, lr: float = 3e-4, pose_dim: int = 282,
                 device=None) -> TrainState:
    """Adam(lr, betas (0.5, 0.999), coupled wd 1e-5); weights drawn from
    torch's generator seeded with `seed`."""
    torch.manual_seed(seed)
    model = FGDAutoEncoder(pose_dim=pose_dim, device=device)
    opt = schedules.adam(model.parameters(), lr=lr, b1=0.5, b2=0.999,
                         weight_decay=1e-5)
    return TrainState(model, opt)


def train_step(state: TrainState, poses: torch.Tensor, rng: int):
    """One update on (B, T, pose_dim) poses, in place; `rng` is the step's
    integer key. Returns the state and {"loss"} (0-d tensor)."""
    model = state.module.train()
    gen = torch.Generator(device=poses.device).manual_seed(rng)
    with dropout_generator(model, gen):
        recon, _ = model(poses)
    loss = losses.l1_loss(recon, poses)
    state.minimize(loss)
    return state, mesh.mean_metrics({"loss": loss.detach()})


def extract_features(state: TrainState, poses: torch.Tensor) -> torch.Tensor:
    """Eval-mode features (test_...py:226-232): (B, T, D) -> (B*T, 512)."""
    with eval_mode(state.module) as model:
        _, latent = model(poses)
    return latent.reshape(-1, latent.shape[-1])
