"""Deterministic synthetic BEAT-style dataset for tests and benchmarks
(SURVEY.md §7 step 5), a copy of emotiongestures_tpu/data/synthetic.py: the
same seed gives the same samples and batches (host numpy). Emotion classes are encoded into both the audio
(class-dependent carrier frequency) and the poses (class-dependent
oscillation), so classifiers/generators have real signal to learn.

Sample layout mirrors the reference window record
(data_loader/lmdb_loader_BEAT_full.py:171-253):
  audio        (64000,)  float32
  spectrogram  (128, 124) float32 log-mel
  pose_seq     (60, 282)  float32
  eid_label    (8,)       one-hot
  text tokens  (60,)      int32 (frame-aligned word indices)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import mel as M

N_POSES = 60
POSE_DIM = 282
FPS = 15
AUDIO_LEN = 64000
SPEC_LEN = 124
N_MELS = 128
N_EMOTIONS = 8


@dataclass
class SyntheticGestureDataset:
    n_samples: int = 256
    n_words: int = 64
    seed: int = 0
    n_poses: int = N_POSES
    pose_dim: int = POSE_DIM
    # samples are deterministic but cost a host mel-spectrogram each;
    # cache up to this many (0 disables). 4096 samples ~ 1.4 GB.
    cache_size: int = 4096
    # class-overlap knob (VERDICT r4 Weak #5): each sample's postural
    # class signature is blended toward the NEXT class's signature by a
    # per-sample weight w ~ U(0, class_overlap). At 0 the classes are
    # cleanly separable and a trained skeleton classifier saturates
    # Emotion-Acc at 100% on a good generator (round-4 flagship check),
    # destroying the metric's ability to rank generators; at moderate
    # overlap (e.g. 0.6) real samples still carry a dominant class
    # signal (the classifier trains well above chance) but a generator
    # must reproduce per-sample posture DETAIL — not just the class
    # mean — to score high, restoring a graded metric.
    class_overlap: float = 0.0

    def __post_init__(self):
        self._cache: dict = {}

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        sample = self._make(idx)
        if len(self._cache) < self.cache_size:
            self._cache[idx] = sample
        return sample

    def _make(self, idx):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        emotion = idx % N_EMOTIONS

        # audio: class-dependent carrier + beat pulses + noise
        t = np.arange(AUDIO_LEN) / 16000.0
        f0 = 110.0 * (1 + emotion)
        beat_hz = 2.0 + 0.25 * emotion
        envelope = 0.5 + 0.5 * np.square(np.sin(np.pi * beat_hz * t))
        audio = (
            0.4 * envelope * np.sin(2 * np.pi * f0 * t)
            + 0.05 * rng.randn(AUDIO_LEN)
        ).astype(np.float32)

        spec = np.asarray(
            M._melspectrogram_np(audio), dtype=np.float64
        )
        spec = M._power_to_db_np(spec)[:, :SPEC_LEN].astype(np.float32)

        # poses: class-dependent POSTURE (constant per-class joint-offset
        # pattern — how real emotional gestures differ, and what the
        # reference's flatten-MLP skeleton classifier can actually learn;
        # a pure-frequency code is FFT-separable but starves that
        # architecture) + class-dependent frequency/amplitude oscillation
        frames = np.arange(self.n_poses) / FPS
        joint_idx = np.arange(1, self.pose_dim + 1)
        posture = 0.08 * np.sin(joint_idx * (emotion + 1) * 0.7)
        if self.class_overlap > 0.0:
            neighbor = 0.08 * np.sin(
                joint_idx * ((emotion + 1) % N_EMOTIONS + 1) * 0.7)
            w = rng.uniform(0.0, self.class_overlap)
            posture = (1.0 - w) * posture + w * neighbor
        joint_phase = rng.uniform(0, 2 * np.pi, self.pose_dim)
        joint_amp = 0.1 + 0.05 * (emotion / N_EMOTIONS) + 0.02 * rng.rand(
            self.pose_dim
        )
        pose = posture[None, :] + joint_amp[None, :] * np.sin(
            2 * np.pi * beat_hz * frames[:, None] + joint_phase[None, :]
        )
        pose = pose + 0.01 * rng.randn(self.n_poses, self.pose_dim)
        pose = pose.astype(np.float32)

        # frame-aligned word indices (sparse, like extend_word_seq)
        tokens = np.zeros(self.n_poses, dtype=np.int32)
        n_spoken = rng.randint(4, 12)
        positions = np.sort(rng.choice(self.n_poses, n_spoken, replace=False))
        tokens[positions] = rng.randint(4, self.n_words, n_spoken)

        eid_label = np.zeros(N_EMOTIONS, dtype=np.float32)
        eid_label[emotion] = 1.0

        # eid index chosen so one_hot_eid(eid) == eid_label (the range
        # boundaries are NOT uniform width-8: lmdb_loader_BEAT_full.py
        # :77-118 / dataset._EID_BOUNDS) — the store-materialized path
        # derives the label from this string
        eid_index = [1, 65, 73, 81, 87, 95, 103, 111][emotion]
        aux_info = {
            "eid": f"1_wayne_0_{eid_index}_{eid_index}",
            "start_time": 0.0,
            "end_time": 4.0,
            "start_frame_no": 0,
            "end_frame_no": self.n_poses,
        }
        return {
            "audio": audio,
            "spectrogram": spec,
            "pose_seq": pose,
            "eid_label": eid_label,
            "text": tokens,
            "aux_info": aux_info,
        }

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, fields=None,
                rows: slice | None = None):
        """Batches of `batch_size` samples in a seeded order; `fields`
        restricts which keys are collated (see make_batch); `rows` takes
        that slice of each batch (a process's rows under data
        parallelism)."""
        order = np.arange(self.n_samples)
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        end = (
            self.n_samples - self.n_samples % batch_size
            if drop_last
            else self.n_samples
        )
        for i in range(0, end, batch_size):
            window = order[i : i + batch_size]
            if rows is not None:
                window = window[rows]
            yield make_batch([self[j] for j in window], fields)


def materialize_store(out_dir, n_samples: int, seed: int = 0,
                      n_words: int = 64, log_every: int = 0,
                      class_overlap: float = 0.0):
    """Materialise the synthetic set into a GestureStore laid out exactly
    like a migrated BEAT cache (lmdb_loader_BEAT_full.py:171-253 record
    semantics): timed `word_seq` entries whose start times land each
    token on its frame under `extend_word_seq`'s floor-grid, float16
    spectrogram (the reference caches store float16,
    utils/train_utils_BEAT.py:189), raw audio, poses, eid aux. Training
    from the store exercises the real host input path (mmap decode,
    `__getitem__` fixups, text-grid assembly, collate) instead of
    regenerating a host mel per sample every epoch. Vocabulary: token t
    becomes the word "w{t}", recovered by the standard `build_vocab` store
    scan. The JAX package's materialize_store writes the same bytes."""
    from .store import GestureStoreWriter

    ds = SyntheticGestureDataset(n_samples=n_samples, seed=seed,
                                 n_words=n_words, cache_size=0,
                                 class_overlap=class_overlap)
    frame_duration = 4.0 / ds.n_poses  # end_time 4.0, start_time 0.0
    with GestureStoreWriter(out_dir) as writer:
        for i in range(n_samples):
            s = ds[i]
            # word start at mid-frame: floor((p+0.25)*fd / fd) == p is
            # robust to float division, while p*fd/fd can floor to p-1
            word_seq = [
                [f"w{int(tok)}", float((p + 0.25) * frame_duration),
                 float((p + 0.75) * frame_duration)]
                for p, tok in enumerate(s["text"]) if tok
            ]
            writer.append({
                "word_seq": word_seq,
                "pose_seq": s["pose_seq"],
                "audio": s["audio"],
                "spectrogram": s["spectrogram"].astype(np.float16),
                "aux_info": s["aux_info"],
            })
            if log_every and (i + 1) % log_every == 0:
                print(f"# materialized {i + 1}/{n_samples}", flush=True)
    return n_samples


BATCH_FIELDS = ("audio", "spectrogram", "pose_seq", "eid_label", "text")


def make_batch(samples, fields=None):
    """Collate samples into stacked numpy arrays
    (audio_classifier_collate_fn / default_collate_fn equivalents).
    `fields` restricts which keys are stacked: the eval CLI with
    --skip_beat never collates the raw audio."""
    return {k: np.stack([s[k] for s in samples])
            for k in (BATCH_FIELDS if fields is None else fields)}
