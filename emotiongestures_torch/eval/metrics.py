"""Scalar metrics of the eval entry point and the meter utility, copied from
emotiongestures_tpu/eval/metrics.py (host numpy). The BEAT-suite extras
(L1div, SRGR) wait for the BEAT data stack."""
from __future__ import annotations

import numpy as np


def l2_distance_pose(fake: np.ndarray, gt: np.ndarray) -> float:
    """(test_...py:46-49): mean per-frame L2 norm of the pose difference."""
    return float(np.mean(np.linalg.norm(gt - fake, axis=-1)))


def mpjre(target: np.ndarray, pred: np.ndarray, rot_dim: int = 6) -> float:
    """Mean absolute 6-d rotation difference (test_...py:223-224);
    multiply by 57.2958 for degrees at report time (test_...py:261)."""
    b = target.shape[0]
    return float(np.mean(np.abs(
        target.reshape(b, -1, rot_dim) - pred.reshape(b, -1, rot_dim))))


def compute_acc(labels: np.ndarray, logits: np.ndarray) -> float:
    """Top-1 accuracy x100 (test_...py:35-39)."""
    preds = np.argmax(logits, axis=1)
    return float(100.0 * np.mean(preds == labels))


class AverageMeter:
    """(utils/average_meter.py:2-23)."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)
