"""Offline preprocessing: raw clip store -> windowed sample-cache store
(data_loader/data_preprocessor.py:16-215 + motion_preprocessor.py:4-87),
the port of emotiongestures_tpu/data/preprocessing.py.

Input records — ONE PER CLIP (the reference nests clips inside video
records; our flat codec stores each clip as its own record):
  {"vid": str(in aux), "skeletons_3d": (T, J, 3), "audio_feat":
   (n_mels, T'), "audio_raw": (n,), "words": [(w, s, e)],
   "aux_info": {"vid", "eid", "start_frame_no", "end_frame_no",
                "start_time", "end_time"}}
stored in a GestureStore (the converter from the original LMDB is the
JAX package's store.convert_lmdb_cache; not ported yet). Output records
match data/dataset.py, and the JAX package's preprocessor writes the same
records.

Window arithmetic is kept identical: stride subdivision
floor((K - N)/S) + 1, spectrogram/raw-audio crops aligned by
floor(start/K * len) with symmetric padding, >=2-word filter, motion
filters, pose -> unit dir-vec + mean-centering.

The clip spectrogram's frontends: "precomputed" crops clip["audio_feat"];
"numpy" computes it on the host (fp64); "xla" and "pallas" compute it on
`device` (the card unless the CPU is asked for) through
ops/fused_mel.py::extract_melspectrogram, "xla" on the plain PyTorch mel,
"pallas" on the CUDA mel kernel `csrc/mel.cu`, one launch per clip (on a
CPU device, the kernel's plain version). The names are the JAX package's.
"""
from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from ..core.device import resolve_device
from ..ops import fused_mel
from ..ops import mel as M
from ..ops.mel import calc_spectrogram_length_from_motion_length
from ..ops.pose import (DIR_VEC_PAIRS, DIR_VEC_PAIRS_EXPRESSIVE,
                        convert_pose_seq_to_dir_vec, resample_pose_seq)
from .store import GestureStore, GestureStoreWriter


class MotionPreprocessor:
    """Window filters (motion_preprocessor.py:4-87): near-mean pose,
    spine angle, static arms — checked in the reference's order."""

    def __init__(self, skeletons, mean_pose):
        self.skeletons = np.array(skeletons)
        self.mean_pose = np.array(mean_pose).reshape(-1, 3)
        self.filtering_message = "PASS"

    def get(self):
        if self.skeletons.size:
            if self.check_pose_diff():
                self.skeletons = np.array([])
                self.filtering_message = "pose"
            elif self.check_spine_angle():
                self.skeletons = np.array([])
                self.filtering_message = "spine angle"
            elif self.check_static_motion():
                self.skeletons = np.array([])
                self.filtering_message = "motion"
        if self.skeletons.size:
            assert not np.isnan(self.skeletons).any()
        return self.skeletons, self.filtering_message

    def check_static_motion(self, left_joint: int = 6, right_joint: int = 9,
                            threshold: float = 0.0014) -> bool:
        def variance(joint_idx):
            return float(np.sum(np.var(self.skeletons[:, joint_idx],
                                       axis=0)))

        return (variance(left_joint) < threshold
                and variance(right_joint) < threshold)

    def check_pose_diff(self, threshold: float = 0.02) -> bool:
        return float(np.mean(np.abs(self.skeletons - self.mean_pose))) \
            < threshold

    def check_spine_angle(self, max_deg: float = 30.0,
                          mean_deg: float = 20.0) -> bool:
        spine = self.skeletons[:, 1] - self.skeletons[:, 0]
        unit = spine / np.linalg.norm(spine, axis=1, keepdims=True)
        angles = np.arccos(np.clip(unit @ np.array([0.0, -1.0, 0.0]),
                                   -1.0, 1.0))
        return (np.rad2deg(np.max(angles)) > max_deg
                or np.rad2deg(np.mean(angles)) > mean_deg)


def get_words_in_time_range(word_list, start_time, end_time):
    """(data_preprocessor.py:173-188)."""
    words = []
    for word in word_list:
        word_s, word_e = word[1], word[2]
        if word_s >= end_time:
            break
        if word_e <= start_time:
            continue
        words.append(word)
    return words


class DataPreprocessor:
    def __init__(self, clip_store_dir, out_store_dir, n_poses: int,
                 subdivision_stride: int, pose_resampling_fps: int,
                 mean_pose=None, mean_dir_vec=None,
                 disable_filtering: bool = False,
                 convert_to_dir_vec: bool = True,
                 dir_vec_pairs=None,
                 spectrogram_frontend: str = "precomputed",
                 device=None):
        """`spectrogram_frontend`: where each clip's mel spectrogram
        comes from. "precomputed" (default, reference semantics:
        utils/train_utils_BEAT.py:186-195 runs offline and the
        preprocessor only CROPS clip['audio_feat']); "numpy" (host
        librosa-formula path), "xla" (the plain PyTorch mel) or "pallas"
        (the CUDA mel kernel) recompute it from clip['audio_raw'], for
        clip stores that never had spectrograms, or to regenerate them at
        full fidelity. `device` serves "xla" and "pallas" only: None is
        the card, and raises without one."""
        if spectrogram_frontend not in ("precomputed", "numpy", "xla",
                                        "pallas"):
            raise ValueError(
                f"unknown spectrogram_frontend {spectrogram_frontend!r}")
        self.spectrogram_frontend = spectrogram_frontend
        self.device = (resolve_device(device)
                       if spectrogram_frontend in ("xla", "pallas") else None)

        self.n_poses = n_poses
        self.subdivision_stride = subdivision_stride
        self.skeleton_resampling_fps = pose_resampling_fps
        self.mean_pose = mean_pose
        self.mean_dir_vec = mean_dir_vec
        if dir_vec_pairs is None:
            # infer the skeleton family from the mean vector: 42 pairs x 3
            # = 126 is the TED-expressive 43-joint layout
            # (lmdb_data_loader_expressive.py:239-260), else the 10-joint
            # TED layout (utils/data_utils.py:27-34)
            expressive = (mean_dir_vec is not None and
                          np.asarray(mean_dir_vec).size == 126)
            dir_vec_pairs = (DIR_VEC_PAIRS_EXPRESSIVE if expressive
                             else DIR_VEC_PAIRS)
        self.dir_vec_pairs = dir_vec_pairs
        # the reference's EXPRESSIVE MotionPreprocessor has every filter
        # commented out — it always returns (skeletons, "PASS") with only
        # a NaN assert (motion_preprocessor_expressive.py:10-31); mirror
        # that as a pass-through whenever the 42-pair layout is active
        self.filters_pass_through = len(self.dir_vec_pairs) == 42
        self.disable_filtering = disable_filtering
        self.convert_to_dir_vec = convert_to_dir_vec
        self.src = GestureStore(clip_store_dir)
        self.out_dir = out_store_dir
        self.spectrogram_sample_length = (
            calc_spectrogram_length_from_motion_length(
                n_poses, pose_resampling_fps))
        self.audio_sample_length = int(
            n_poses / pose_resampling_fps * 16000)
        self.n_out_samples = 0

    def run(self):
        n_filtered_out = defaultdict(int)
        with GestureStoreWriter(self.out_dir) as writer:
            for i in range(len(self.src)):
                clip = self.src[i]
                vid = clip.get("aux_info", {}).get("vid", str(i))
                result = self._sample_from_clip(vid, clip, writer)
                for kind, n in result.items():
                    n_filtered_out[kind] += n
        self.src.close()
        return dict(n_filtered_out), self.n_out_samples

    def _clip_spectrogram(self, audio_raw: np.ndarray) -> np.ndarray:
        """Clip-level log-mel via the selected compute frontend
        (float16, the reference's cache dtype). The wave is copied out of
        the read-only map before a tensor is made of it."""
        wave = np.array(audio_raw, dtype=np.float32)
        if self.spectrogram_frontend == "numpy":
            return M._power_to_db_np(
                M._melspectrogram_np(wave)).astype(np.float16)
        return fused_mel.extract_melspectrogram(
            wave, use_kernel=self.spectrogram_frontend == "pallas",
            device=self.device).cpu().numpy()

    def _sample_from_clip(self, vid, clip, writer):
        clip_skeleton = np.asarray(clip["skeletons_3d"])
        if self.spectrogram_frontend != "precomputed":
            clip_audio = self._clip_spectrogram(clip["audio_raw"])
        elif "audio_feat" not in clip:
            raise KeyError(
                "clip record has no 'audio_feat' spectrogram — pass "
                "spectrogram_frontend='numpy'/'xla'/'pallas' to compute "
                "it from audio_raw")
        else:
            clip_audio = np.asarray(clip["audio_feat"])
        clip_audio_raw = np.asarray(clip["audio_raw"])
        clip_word_list = clip["words"]
        clip_aux = clip.get("aux_info", {})
        clip_s_f = clip_aux.get("start_frame_no", 0)
        clip_s_t = clip_aux.get("start_time", 0.0)
        clip_e_t = clip_aux.get(
            "end_time", len(clip_skeleton) / self.skeleton_resampling_fps)
        n_filtered_out = defaultdict(int)

        clip_skeleton = resample_pose_seq(
            clip_skeleton, clip_e_t - clip_s_t, self.skeleton_resampling_fps)

        num_subdivision = math.floor(
            (len(clip_skeleton) - self.n_poses) / self.subdivision_stride
        ) + 1
        for i in range(num_subdivision):
            start_idx = i * self.subdivision_stride
            fin_idx = start_idx + self.n_poses
            sample_skeletons = clip_skeleton[start_idx:fin_idx]
            sub_start_t = clip_s_t + start_idx / self.skeleton_resampling_fps
            sub_end_t = clip_s_t + fin_idx / self.skeleton_resampling_fps
            sample_words = get_words_in_time_range(
                clip_word_list, sub_start_t, sub_end_t)

            # spectrogram crop (data_preprocessor.py:106-116)
            a_start = math.floor(
                start_idx / len(clip_skeleton) * clip_audio.shape[1])
            a_end = a_start + self.spectrogram_sample_length
            if a_end > clip_audio.shape[1]:
                padded = np.pad(clip_audio,
                                ((0, 0), (0, a_end - clip_audio.shape[1])),
                                mode="symmetric")
                sample_spectrogram = padded[:, a_start:a_end]
            else:
                sample_spectrogram = clip_audio[:, a_start:a_end]

            # raw-audio crop (data_preprocessor.py:118-128)
            r_start = math.floor(
                start_idx / len(clip_skeleton) * len(clip_audio_raw))
            r_end = r_start + self.audio_sample_length
            if r_end > len(clip_audio_raw):
                padded = np.pad(clip_audio_raw,
                                (0, r_end - len(clip_audio_raw)),
                                mode="symmetric")
                sample_audio = padded[r_start:r_end]
            else:
                sample_audio = clip_audio_raw[r_start:r_end]

            if len(sample_words) >= 2:
                if self.filters_pass_through:
                    # expressive semantics: no filtering, NaN guard only
                    # (motion_preprocessor_expressive.py:26-29). ValueError,
                    # not assert: must survive python -O, and aborting run()
                    # makes the writer discard the partial cache (store.py
                    # writes atomically on clean close only).
                    if np.isnan(sample_skeletons).any():
                        raise ValueError(
                            f"missing joints (NaN) in clip {vid} window "
                            f"{start_idx}:{fin_idx}")
                    message = "PASS"
                    is_correct = True
                elif self.mean_pose is not None:
                    sample_skeletons, message = MotionPreprocessor(
                        sample_skeletons, self.mean_pose).get()
                    is_correct = sample_skeletons.size > 0
                else:
                    message = "PASS"
                    is_correct = True
                aux = {
                    "vid": vid,
                    "eid": clip_aux.get("eid", vid),
                    "start_frame_no": int(clip_s_f + start_idx),
                    "end_frame_no": int(clip_s_f + fin_idx),
                    "start_time": float(sub_start_t),
                    "end_time": float(sub_end_t),
                    "is_correct_motion": bool(is_correct),
                    "filtering_message": message,
                }
                if is_correct or self.disable_filtering:
                    poses = np.asarray(
                        sample_skeletons if is_correct
                        else clip_skeleton[start_idx:fin_idx],
                        dtype=np.float32)
                    record = {
                        "word_seq": [list(w) for w in sample_words],
                        "pose_seq": poses,
                        "audio": np.asarray(sample_audio, np.float32),
                        "spectrogram": np.asarray(sample_spectrogram,
                                                  np.float16),
                        "aux_info": aux,
                    }
                    if self.convert_to_dir_vec and self.mean_dir_vec \
                            is not None:
                        dir_vec = convert_pose_seq_to_dir_vec(
                            poses, pairs=self.dir_vec_pairs)
                        record["vec_seq"] = (
                            dir_vec.reshape(len(poses), -1)
                            - np.asarray(self.mean_dir_vec).reshape(1, -1)
                        ).astype(np.float32)
                    writer.append(record)
                    self.n_out_samples += 1
                else:
                    n_filtered_out[message] += 1
        return n_filtered_out
