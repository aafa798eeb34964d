"""Scalar metrics of the eval entry point, the BEAT-suite extras (L1div,
SRGR from model/Beat_score.py:12-49) and the meter utility, copied from
emotiongestures_tpu/eval/metrics.py (host numpy)."""
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


class L1div:
    """(model/Beat_score.py:12-24)."""

    def __init__(self):
        self.counter = 0
        self.sum = 0.0

    def run(self, results: np.ndarray):
        self.counter += results.shape[0]
        mean = np.mean(results, 0)
        self.sum += float(np.sum(np.abs(results - mean)))

    def avg(self):
        return self.sum / self.counter


class SRGR:
    """Semantic-relevant gesture recall (model/Beat_score.py:27-49)."""

    def __init__(self, threshold: float = 0.1, joints: int = 47):
        self.threshold = threshold
        self.pose_dims = joints
        self.counter = 0
        self.sum = 0.0

    def run(self, results, targets, semantic):
        results = results.reshape(-1, self.pose_dims, 3)
        targets = targets.reshape(-1, self.pose_dims, 3)
        semantic = np.asarray(semantic).reshape(-1)
        diff = np.sum(np.abs(results - targets), 2)
        success = np.where(diff < self.threshold, 1.0, 0.0)
        success = success * semantic[:, None] * (1 / 0.165)
        rate = np.sum(success) / (success.shape[0] * success.shape[1])
        self.counter += success.shape[0]
        self.sum += rate * success.shape[0]
        return rate

    def avg(self):
        return self.sum / self.counter


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
