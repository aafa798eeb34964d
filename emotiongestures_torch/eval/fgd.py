"""Fréchet Gesture Distance + diversity score (model/FHD_score.py), a copy
of emotiongestures_tpu/eval/fgd.py (host numpy/scipy; the port imports
nothing of the JAX package). The features come from the FGD autoencoder on
the card; the 512x512 sqrtm stays on the host. Numerical semantics are the
reference's, including the "return 100 on ValueError" failure mode
(FHD_score.py:213-214) and the eps-offset retry when sqrtm is not finite.
"""
from __future__ import annotations

import warnings

import numpy as np
from scipy import linalg, stats


def _sqrtm(a):
    """scipy's sqrtm without its singular-matrix warning, as the
    reference's `disp=False` has it; newer SciPy has no `disp` argument."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", linalg.LinAlgWarning)
        return linalg.sqrtm(a)


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """(model/FHD_score.py:159-217) d^2 = |mu1-mu2|^2 + Tr(C1+C2-2 sqrt(C1 C2));
    returns 100 when sqrtm produces a non-negligible imaginary part."""
    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape
    assert sigma1.shape == sigma2.shape
    diff = mu1 - mu2
    try:
        covmean = _sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(covmean):
            if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
                m = np.max(np.abs(covmean.imag))
                raise ValueError(f"Imaginary component {m}")
            covmean = covmean.real
        tr_covmean = np.trace(covmean)
    except ValueError:
        return 100
    return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
            - 2 * tr_covmean)


def calculate_activation_statistics(features: np.ndarray):
    """(model/FHD_score.py:220-242) features: (N, dims)."""
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_from_features(pred_features: np.ndarray,
                          target_features: np.ndarray):
    """The eval entry point's pooling (test_...py:250-255)."""
    mu1, s1 = calculate_activation_statistics(pred_features)
    mu2, s2 = calculate_activation_statistics(target_features)
    return calculate_frechet_distance(mu1, s1, mu2, s2)


def calculate_diversity(activations: np.ndarray, rng: np.random.RandomState,
                        diversity_times: int = 5) -> float:
    """(model/FHD_score.py:270-311): mean pairwise Frobenius distance over
    random index pairs of the (N, 60, 512) feature windows."""
    n = activations.shape[0]
    first = rng.randint(0, n, diversity_times)
    second = rng.randint(0, n, diversity_times)
    div = 0.0
    for i, j in zip(first, second):
        div += float(np.linalg.norm(activations[i] - activations[j]))
    return div / diversity_times


def diversity_score(activations: np.ndarray, seed: int | None = None,
                    confidence_interval: int = 10):
    """(model/FHD_score.py:247-265): 10 repeats of calculate_diversity,
    95% normal CI; returns (score, (lo, hi)). `seed` pins the sampling
    (the reference uses global numpy state)."""
    act = activations.reshape(-1, 60, 512)
    rng = np.random.RandomState(seed)
    vals = np.array([
        calculate_diversity(act, rng) for _ in range(confidence_interval)
    ]).reshape(confidence_interval, 1)
    div_mean = np.mean(vals, axis=0)
    div_std = np.std(vals, axis=0)
    if np.all(div_std == 0):  # degenerate CI (scipy yields NaN at scale=0)
        interval = (div_mean.copy(), div_mean.copy())
    else:
        interval = stats.norm.interval(0.95, div_mean, div_std)
    score = (interval[0] + interval[1]) / 2
    return float(score[0]), (float(interval[0][0]), float(interval[1][0]))
