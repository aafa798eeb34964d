"""Loss functions (port of emotiongestures_tpu/core/losses.py):

  * focal loss            - train_audio_classifier_K_fold.py:89-105
  * softmax contrastive   - test_emotion_gesture_diversity_iterative.py:80-127
  * GAN losses (non-saturating, hinge and LSGAN)
  * KL divergence for the CVAE prior (standard VAE ELBO)
  * regression losses (L1 / L2 / Huber)

Every function computes in its inputs' dtype; the trainers upcast model
outputs to fp32 before calling them, as the JAX package does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample CE with integer labels (CrossEntropyLoss,
    reduction='none')."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long())[:, 0]


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               alpha: Optional[torch.Tensor] = None, gamma: float = 2.0,
               reduction: str = "mean") -> torch.Tensor:
    """ce = CE(logits, y); pt = exp(-ce); loss = alpha_y (1 - pt)^gamma ce.
    `alpha` is a per-class weight vector or a scalar."""
    ce = cross_entropy(logits, labels)
    pt = torch.exp(-ce)
    if alpha is None:
        a = 1.0
    else:
        alpha = torch.as_tensor(alpha, dtype=ce.dtype, device=ce.device)
        a = alpha[labels.long()] if alpha.ndim > 0 else alpha
    loss = a * (1.0 - pt) ** gamma * ce
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _l2_normalise(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-12)


def _inverse_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's similarity: 1 / (||a_i - b_j|| + 1e-8), at least
    1e-8, with the distance from the expanded square."""
    d2 = ((a ** 2).sum(1)[:, None] - 2.0 * a @ b.T
          + (b ** 2).sum(1)[None, :])
    dist = torch.sqrt(torch.clamp(d2, min=1e-12))
    return torch.clamp(1.0 / (dist + 1e-8), min=1e-8)


def softmax_contrastive_loss(feat_a: torch.Tensor,
                             feat_b: torch.Tensor) -> torch.Tensor:
    """SoftmaxContrastiveLoss (test_...py:80-127): l2-normalise both sets,
    a B x B inverse-distance similarity, cross-entropy against the
    diagonal."""
    cross = _inverse_distance(_l2_normalise(feat_a), _l2_normalise(feat_b))
    labels = torch.arange(cross.shape[0], device=cross.device)
    return cross_entropy(cross, labels).mean()


def emotion_infonce(features: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Paired-clip emotion InfoNCE: clips sharing an emotion label are
    positives, every other clip of the batch a negative, with the
    reference's similarity kernel. A clip with no same-label partner in the
    batch contributes zero. `features` (B, D), `labels` (B,) int."""
    f = _l2_normalise(features)
    sim = _inverse_distance(f, f)
    b = features.shape[0]
    eye = torch.eye(b, dtype=torch.bool, device=features.device)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    neg_inf = torch.tensor(float("-inf"), dtype=sim.dtype, device=sim.device)
    logp = torch.log_softmax(torch.where(eye, neg_inf, sim), dim=1)
    pos_logp = torch.logsumexp(torch.where(pos, logp, neg_inf), dim=1)
    has_pos = pos.any(dim=1)
    per_clip = torch.where(has_pos, -pos_logp, torch.zeros_like(pos_logp))
    return per_clip.sum() / torch.clamp(has_pos.sum(), min=1)


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(q(z|x) || N(0, I)) summed over latent dims, averaged over batch."""
    return (-0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar)).sum(-1)).mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def huber_loss(pred: torch.Tensor, target: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    abs_err = (pred - target).abs()
    quad = torch.clamp(abs_err, max=delta)
    return (0.5 * quad ** 2 + delta * (abs_err - quad)).mean()


# GAN losses. Motion_Discriminator emits raw scores (Models_memory.py:
# 600-603): BCE with logits, or hinge; Pose_Discriminator emits sigmoid
# probabilities (Models.py:482-510).


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    return (F.relu(logits) - logits * target
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def gan_d_loss(real_logits: torch.Tensor,
               fake_logits: torch.Tensor) -> torch.Tensor:
    return bce_with_logits(real_logits, 1.0) + bce_with_logits(fake_logits,
                                                               0.0)


def gan_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return bce_with_logits(fake_logits, 1.0)


def hinge_d_loss(real_logits: torch.Tensor,
                 fake_logits: torch.Tensor) -> torch.Tensor:
    return F.relu(1.0 - real_logits).mean() + F.relu(1.0 + fake_logits).mean()


def hinge_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return -fake_logits.mean()


def lsgan_d_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return ((real - 1.0) ** 2).mean() + (fake ** 2).mean()


def lsgan_g_loss(fake: torch.Tensor) -> torch.Tensor:
    return ((fake - 1.0) ** 2).mean()
