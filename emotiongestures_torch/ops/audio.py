"""Misc audio/metric ops from model/utils.py (the port of
emotiongestures_tpu/ops/audio.py): the pre-emphasis filter on tensors and
precision@k on numpy."""
from __future__ import annotations

import numpy as np
import torch


def pre_emphasis(x: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """PreEmphasis filter (model/utils.py:22-38): y[t] = x[t] - coef *
    x[t-1] with reflect padding on the left. x: (B, n) or (n,)."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    padded = torch.cat([x[:, 1:2], x], dim=1)  # reflect pad 1
    y = padded[:, 1:] - coef * padded[:, :-1]
    return y[0] if squeeze else y


def topk_accuracy(logits: np.ndarray, targets: np.ndarray,
                  topk=(1,)) -> list:
    """precision@k (model/utils.py:7-20), values in percent."""
    order = np.argsort(-np.asarray(logits), axis=1)
    targets = np.asarray(targets)
    out = []
    for k in topk:
        hit = (order[:, :k] == targets[:, None]).any(axis=1)
        out.append(100.0 * float(hit.mean()))
    return out
