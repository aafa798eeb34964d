"""Pose/skeleton utilities (utils/data_utils.py:13-121 and the 43-joint
TED-expressive variant utils/data_utils_expressive.py:12-201), vectorised
numpy on the host, a copy of emotiongestures_tpu/ops/pose.py:
direction-vector <-> joint-position conversion, linear pose resampling,
and the text normalisers.
"""
from __future__ import annotations

import re

import numpy as np

# TED 10-joint skeleton, (parent, child, bone length): the reference's
# table (utils/data_utils.py:15-16)
DIR_VEC_PAIRS = [(0, 1, 0.26), (1, 2, 0.18), (2, 3, 0.14), (1, 4, 0.22),
                 (4, 5, 0.36), (5, 6, 0.33), (1, 7, 0.22), (7, 8, 0.36),
                 (8, 9, 0.33)]

# TED-expressive 43-joint skeleton (utils/data_utils_expressive.py:12-60)
DIR_VEC_PAIRS_EXPRESSIVE = [
    (0, 1, 0.26), (1, 2, 0.22), (1, 3, 0.22), (2, 4, 0.36), (4, 6, 0.33),
    (6, 8, 0.137), (8, 9, 0.044), (9, 10, 0.031),
    (6, 11, 0.144), (11, 12, 0.042), (12, 13, 0.033),
    (6, 14, 0.127), (14, 15, 0.027), (15, 16, 0.026),
    (6, 17, 0.134), (17, 18, 0.039), (18, 19, 0.033),
    (6, 20, 0.068), (20, 21, 0.042), (21, 22, 0.036),
    (3, 5, 0.36), (5, 7, 0.33),
    (7, 23, 0.137), (23, 24, 0.044), (24, 25, 0.031),
    (7, 26, 0.144), (26, 27, 0.042), (27, 28, 0.033),
    (7, 29, 0.127), (29, 30, 0.027), (30, 31, 0.026),
    (7, 32, 0.134), (32, 33, 0.039), (33, 34, 0.033),
    (7, 35, 0.068), (35, 36, 0.042), (36, 37, 0.036),
    (1, 38, 0.18), (38, 39, 0.14), (38, 40, 0.14), (39, 41, 0.15),
    (40, 42, 0.15),
]


def _n_joints(pairs):
    return max(max(p[0], p[1]) for p in pairs) + 1


def convert_dir_vec_to_pose(vec: np.ndarray, pairs=DIR_VEC_PAIRS
                            ) -> np.ndarray:
    """Unit direction vectors (..., n_pairs, 3) or flattened
    (..., n_pairs*3) -> joint positions (..., n_joints, 3)
    (utils/data_utils.py:79-100). Works for any leading dims."""
    vec = np.asarray(vec)
    if vec.shape[-1] != 3:
        vec = vec.reshape(vec.shape[:-1] + (-1, 3))
    n_joints = _n_joints(pairs)
    joint_pos = np.zeros(vec.shape[:-2] + (n_joints, 3), dtype=vec.dtype)
    for j, (parent, child, length) in enumerate(pairs):
        joint_pos[..., child, :] = (
            joint_pos[..., parent, :] + length * vec[..., j, :])
    return joint_pos


def convert_pose_seq_to_dir_vec(pose: np.ndarray, pairs=DIR_VEC_PAIRS
                                ) -> np.ndarray:
    """Joint positions (..., n_joints, 3) or flattened -> unit direction
    vectors (..., n_pairs, 3) (utils/data_utils.py:103-121)."""
    pose = np.asarray(pose)
    if pose.shape[-1] != 3:
        pose = pose.reshape(pose.shape[:-1] + (-1, 3))
    dir_vec = np.stack(
        [pose[..., child, :] - pose[..., parent, :]
         for parent, child, _ in pairs], axis=-2)
    norm = np.linalg.norm(dir_vec, axis=-1, keepdims=True)
    return dir_vec / np.maximum(norm, 1e-12)


def resample_pose_seq(poses: np.ndarray, duration_in_sec: float,
                      fps: int) -> np.ndarray:
    """Linear resampling to `duration * fps` frames
    (utils/data_utils.py:48-59)."""
    from scipy.interpolate import interp1d

    n = len(poses)
    x = np.arange(0, n)
    f = interp1d(x, poses, axis=0, kind="linear", fill_value="extrapolate")
    expected_n = duration_in_sec * fps
    x_new = np.arange(0, n, n / expected_n)
    out = f(x_new)
    if hasattr(poses, "dtype"):
        out = out.astype(poses.dtype)
    return out


def normalize_string(s: str) -> str:
    """(utils/data_utils.py:19-26)."""
    s = s.lower().strip()
    s = re.sub(r"([,.!?])", r" \1 ", s)
    s = re.sub(r"(['])", r"", s)
    s = re.sub(r"[^a-zA-Z,.!?]+", r" ", s)
    s = re.sub(r"\s+", r" ", s).strip()
    return s


def remove_tags_marks(text: str) -> str:
    return re.sub(re.compile("<.*?>|[.,:;!?]+"), "", text)


def time_stretch_for_words(words, start_time, speech_speed_rate):
    """(utils/data_utils.py:62-67)."""
    for i in range(len(words)):
        if words[i][1] > start_time:
            words[i][1] = start_time + (
                words[i][1] - start_time) / speech_speed_rate
        words[i][2] = start_time + (
            words[i][2] - start_time) / speech_speed_rate
    return words
