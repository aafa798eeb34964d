"""TED's FGD evaluator (port of emotiongestures_tpu/eval/
embedding_space_evaluator.py; reference model/embedding_space_evaluator.py:
16-209): the EmbeddingNet (pose_dim 27, `pose` mode) or MotionAE (pose_dim
126) feature net embeds real and generated windows; the latents gather on
the host, where the Fréchet distance, the feature distance, the diversity
and the reconstruction diagnostics are computed. The Fréchet distance is
eval/fgd.py's, whose failure value 100 this evaluator reports as 1e10, as
the reference's does. UMAP is an optional import.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.baselines import EmbeddingNet, MotionAE
from ..utils.weights import load_reference_state
from .fgd import calculate_frechet_distance


class EmbeddingSpaceEvaluator:
    """`state_dict` (reference layout) loads the feature net with
    strict=True; without one its weights are drawn from torch's generator
    seeded with `seed`. The net runs on `device` (the card unless the CPU
    is asked for), in eval mode."""

    def __init__(self, pose_dim: int, n_frames: int = 34, n_words: int = 64,
                 latent_dim: int = 128, n_pre_poses: int = 4,
                 state_dict=None, seed: int = 0, device=None):
        self.pose_dim, self.n_pre_poses = pose_dim, n_pre_poses
        self.device = resolve_device(device)
        torch.manual_seed(seed)
        if pose_dim == 126:
            self.net = MotionAE(pose_dim, latent_dim, n_frames,
                                device=self.device)
        else:
            self.net = EmbeddingNet(n_words, pose_dim, n_frames, mode="pose",
                                    n_pre_poses=n_pre_poses,
                                    device=self.device)
        if state_dict is not None:
            load_reference_state(self.net, state_dict)
        self.reset()

    @torch.no_grad()
    def embed(self, poses):
        """(reconstruction, latent) as numpy, for (B, n_frames, pose_dim)
        poses."""
        poses = torch.as_tensor(np.asarray(poses), dtype=torch.float32,
                                device=self.device)
        if isinstance(self.net, MotionAE):
            recon, feat = self.net(poses)
        else:
            out = self.net(None, None, poses[:, : self.n_pre_poses], poses,
                           input_mode="pose")
            feat, recon = out[3], out[6]
        return recon.cpu().numpy(), feat.cpu().numpy()

    def reset(self):
        self.context_feat_list = []
        self.real_feat_list = []
        self.generated_feat_list = []
        self.recon_err_diff = []
        self.cos_err_diff = []

    def get_no_of_samples(self):
        return len(self.real_feat_list)

    @staticmethod
    def _recon_err(recon, poses):
        """Per-sample L1 + pose-difference L1, summed
        (embedding_space_evaluator.py:79-98)."""
        loss = np.mean(np.abs(recon - poses), axis=(1, 2))
        target_diff = poses[:, 1:] - poses[:, :-1]
        recon_diff = recon[:, 1:] - recon[:, :-1]
        loss = loss + np.mean(np.abs(recon_diff - target_diff), axis=(1, 2))
        return np.sum(loss)

    @staticmethod
    def _cos_err(recon, poses):
        r = recon.reshape(recon.shape[0], recon.shape[1], -1, 3)
        p = poses.reshape(poses.shape[0], poses.shape[1], -1, 3)
        num = np.sum(r * p, axis=-1)
        den = np.maximum(
            np.linalg.norm(r, axis=-1) * np.linalg.norm(p, axis=-1), 1e-8)
        return np.sum(1.0 - num / den)

    def push_samples(self, generated_poses, real_poses):
        real_recon, real_feat = self.embed(real_poses)
        gen_recon, gen_feat = self.embed(generated_poses)
        self.real_feat_list.append(real_feat)
        self.generated_feat_list.append(gen_feat)
        real_poses = np.asarray(real_poses)
        generated_poses = np.asarray(generated_poses)
        self.recon_err_diff.append(
            self._recon_err(gen_recon, generated_poses)
            - self._recon_err(real_recon, real_poses))
        self.cos_err_diff.append(
            self._cos_err(gen_recon, generated_poses)
            - self._cos_err(real_recon, real_poses))

    def get_diversity_scores(self, seed: int = 0):
        """(embedding_space_evaluator.py:115-125)."""
        feat1 = np.vstack(self.generated_feat_list[:500])
        rng = np.random.RandomState(seed)
        random_idx = rng.permutation(len(self.generated_feat_list))[:500]
        feat2 = np.vstack([self.generated_feat_list[i] for i in random_idx])
        return float(np.mean(np.sum(np.abs(feat1 - feat2), axis=-1)))

    def get_scores(self):
        """(frechet distance, feature distance); 1e10 where the Fréchet
        helper fails (embedding_space_evaluator.py:127-154)."""
        generated = np.vstack(self.generated_feat_list)
        real = np.vstack(self.real_feat_list)
        mu_g, s_g = np.mean(generated, 0), np.cov(generated, rowvar=False)
        mu_r, s_r = np.mean(real, 0), np.cov(real, rowvar=False)
        fd = calculate_frechet_distance(mu_g, s_g, mu_r, s_r)
        if fd == 100:  # eval/fgd.py's failure value
            fd = 1e10
        feat_dist = float(np.mean(
            np.sum(np.abs(real - generated[: len(real)]), axis=-1)))
        return fd, feat_dist

    def get_features_for_viz(self):
        """A 2-d UMAP projection of the generated and real latents; needs
        the optional `umap` package."""
        import umap

        generated = np.vstack(self.generated_feat_list)
        real = np.vstack(self.real_feat_list)
        transformed = umap.UMAP().fit_transform(np.vstack((generated, real)))
        n = transformed.shape[0] // 2
        return transformed[n:], transformed[:n]
