"""Human3.6M pose-pretraining dataset (data_loader/h36m_loader.py:14-106),
the port of emotiongestures_tpu/data/h36m.py (host numpy): 12 target
joints, hip-vector frontalisation, optional gaussian noise augmentation,
dir-vec normalisation against a mean vector.
"""
from __future__ import annotations

import math

import numpy as np

from ..ops.pose import convert_dir_vec_to_pose, convert_pose_seq_to_dir_vec

TRAIN_SUBJECTS = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]
TEST_SUBJECTS = ["S11"]
TARGET_JOINTS = [1, 6, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27]


def rotation_matrix(axis, theta):
    """(h36m_loader.py:92-106)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / math.sqrt(np.dot(axis, axis))
    a = math.cos(theta / 2.0)
    b, c, d = -axis * math.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array(
        [[aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
         [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
         [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc]])


def normalize_h36m(data: np.ndarray) -> np.ndarray:
    """Root-centering, axis swap, hip-vector frontalisation
    (h36m_loader.py:69-90). data: (T, J, 3)."""
    data = np.array(data, dtype=np.float64)
    for f in range(data.shape[0]):
        data[f, :] -= data[f, 2]
        data[f, :, (0, 1, 2)] = data[f, :, (0, 2, 1)]
        data[f, :, 1] = -data[f, :, 1]
    for f in range(data.shape[0]):
        hip_vec = data[f, 1] - data[f, 0]
        angle = np.pi - math.atan2(hip_vec[2], hip_vec[0])
        if 180 < np.rad2deg(angle) < 360:
            angle = angle - np.deg2rad(360)
        data[f] = np.matmul(data[f], rotation_matrix([0, 1, 0], angle))
    return data[:, 2:]  # exclude hip joints


class Human36M:
    """(h36m_loader.py:14-67). `data` may be the .npz path of the
    positions_3d archive, or an in-memory {subject: {action: (T, 32, 3)}}
    dict for tests."""

    def __init__(self, data, mean_data, is_train=True, augment=False,
                 n_poses: int = 34, frame_stride: int = 2,
                 window_stride: int = 10, seed: int = 0):
        self.is_train = is_train
        self.augment = augment
        self.mean_data = np.asarray(mean_data)
        self.data = []
        self._rng = np.random.RandomState(seed)

        if isinstance(data, (str, bytes)):
            data = np.load(data, allow_pickle=True)["positions_3d"].item()
        subjects = TRAIN_SUBJECTS if is_train else TEST_SUBJECTS
        for subject, actions in data.items():
            if subject not in subjects:
                continue
            for _, positions in actions.items():
                positions = np.asarray(positions)[:, TARGET_JOINTS]
                positions = normalize_h36m(positions)
                for f in range(0, len(positions), window_stride):
                    if f + n_poses * frame_stride > len(positions):
                        break
                    self.data.append(
                        positions[f : f + n_poses * frame_stride
                                  : frame_stride])

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        poses = self.data[index]
        dir_vec = convert_pose_seq_to_dir_vec(poses)
        poses = convert_dir_vec_to_pose(dir_vec)
        if self.augment:  # gaussian joint noise (h36m_loader.py:49-56)
            std = 0.002**0.5 if self._rng.random_sample() < 0.2 \
                else 0.0001**0.5
            poses = poses + self._rng.normal(0, std, poses.shape)
        dir_vec = convert_pose_seq_to_dir_vec(poses)
        dir_vec = dir_vec.reshape(dir_vec.shape[0], -1) - self.mean_data
        return poses.astype(np.float32), dir_vec.astype(np.float32)
