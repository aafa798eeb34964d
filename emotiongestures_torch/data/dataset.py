"""SpeechMotionDataset over GestureStore, the host-side sample path
(data_loader/lmdb_loader_BEAT_full.py:120-276), lmdb+pyarrow replaced by
the self-owned codec/store; the port of emotiongestures_tpu/data/dataset.py.
Both packages feed the same rows in the same order from one store.

Returns dict samples compatible with `make_batch` collation; the
reference's three collate functions map to which keys a consumer reads:
  audio_classifier_collate_fn -> audio/spectrogram/pose_seq/eid_label
  default_collate_fn          -> + text (frame-aligned word indices)
  word_seq_collate_fn         -> + word tokens with lengths (provided by
                                  `words_to_tensor` below)

A record's arrays are read-only views into the store's map: `__getitem__`
copies them, so a sample's arrays are its own and a tensor can be made of
them. The module counts the batches `batches` assembled through the C++
gather (`native_batches`) and per record (`exact_batches`).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.mel import (
    calc_spectrogram_length_from_motion_length,
    make_audio_fixed_length,
)
from .constants import EMOTION_LABELS  # noqa: F401
from .store import GestureStore
from .synthetic import BATCH_FIELDS, make_batch
from .vocab import Vocab

native_batches = 0
exact_batches = 0

# emotion-id ranges (lmdb_loader_BEAT_full.py:77-118)
_EID_BOUNDS = [64, 72, 80, 86, 94, 102, 110, 118]


def one_hot_eid(eid: str) -> np.ndarray:
    index = int(eid.split("_", 4)[-1])
    label = np.zeros(8, dtype=np.float32)
    for cls, bound in enumerate(_EID_BOUNDS):
        if index <= bound:
            label[cls] = 1.0
            return label
    raise ValueError(f"eid index {index} out of range")


def extend_word_seq(lang: Vocab, words, aux_info, n_frames: int,
                    remove_word_timing: bool = False,
                    end_time=None) -> np.ndarray:
    """Timed words -> per-frame index grid
    (lmdb_loader_BEAT_full.py:182-207)."""
    if end_time is None:
        end_time = aux_info["end_time"]
    frame_duration = (end_time - aux_info["start_time"]) / n_frames
    extended = np.zeros(n_frames, dtype=np.int64)
    if remove_word_timing:
        n_words = 0
        for word in words:
            idx = max(0, int(np.floor(
                (word[1] - aux_info["start_time"]) / frame_duration)))
            if idx < n_frames:
                n_words += 1
        space = int(n_frames / (n_words + 1))
        for i in range(n_words):
            idx = (i + 1) * space
            extended[idx] = lang.get_word_index(words[i][0])
    else:
        for word in words:
            idx = max(0, int(np.floor(
                (word[1] - aux_info["start_time"]) / frame_duration)))
            if idx < n_frames:
                extended[idx] = lang.get_word_index(word[0])
    return extended


def words_to_tensor(lang: Vocab, words, end_time=None) -> np.ndarray:
    """SOS + word indices + EOS (lmdb_loader_BEAT_full.py:209-216)."""
    indexes = [lang.SOS_token]
    for word in words:
        if end_time is not None and word[1] > end_time:
            break
        indexes.append(lang.get_word_index(word[0]))
    indexes.append(lang.EOS_token)
    return np.asarray(indexes, dtype=np.int64)


def word_seq_collate(samples):
    """word_seq_collate_fn equivalent (lmdb_loader_BEAT_full.py:26-46):
    sort by token-sequence length (desc), pad with PAD=0, return lengths
    alongside the stacked batch arrays."""
    samples = sorted(samples, key=lambda s: len(s["word_tokens"]),
                     reverse=True)
    lengths = np.asarray([len(s["word_tokens"]) for s in samples],
                         dtype=np.int64)
    max_len = int(lengths[0]) if len(lengths) else 0
    tokens = np.zeros((len(samples), max_len), dtype=np.int64)
    for i, s in enumerate(samples):
        tokens[i, : lengths[i]] = s["word_tokens"]
    batch = make_batch(samples)
    batch["word_tokens"] = tokens
    batch["word_lengths"] = lengths
    return batch


class SpeechMotionDataset:
    """Windowed (audio, spectrogram, poses, emotion) samples from a
    GestureStore cache directory (`<data_dir>_cache` convention kept)."""

    def __init__(self, data_dir, n_poses: int = 60,
                 subdivision_stride: int = 30,
                 pose_resampling_fps: int = 15,
                 speaker_model=None, remove_word_timing: bool = False,
                 use_cache_suffix: bool = True):
        self.data_dir = Path(data_dir)
        self.n_poses = n_poses
        self.subdivision_stride = subdivision_stride
        self.skeleton_resampling_fps = pose_resampling_fps
        self.remove_word_timing = remove_word_timing
        self.expected_audio_length = int(
            round(n_poses / pose_resampling_fps * 16000))
        self.expected_spectrogram_length = (
            calc_spectrogram_length_from_motion_length(
                n_poses, pose_resampling_fps))
        self.lang_model: Vocab | None = None
        cache_dir = (
            Path(str(self.data_dir) + "_cache")
            if use_cache_suffix else self.data_dir
        )
        if not (cache_dir / "index.npy").exists():
            raise FileNotFoundError(
                f"no GestureStore at {cache_dir} (the sample cache of "
                f"{self.data_dir}): make one with data.preprocessing."
                "DataPreprocessor over a clip store, or data.synthetic."
                "materialize_store")
        self.store = GestureStore(cache_dir)
        self.speaker_model = speaker_model or self._speaker_model()

    def _speaker_model(self):
        """The eid vocabulary, cached at `<data_dir>_speaker_model.pkl` in
        the pickle both packages read (data/vocab.py)."""
        cache = Path(str(self.data_dir) + "_speaker_model.pkl")
        if cache.exists():
            return Vocab.load(cache)
        model = Vocab("eid", insert_default_tokens=False)
        for i in range(len(self.store)):
            model.index_word(self.store.json_fields(i)["aux_info"]["eid"])
        try:
            model.save(cache)
        except OSError:
            pass
        return model

    def set_lang_model(self, lang_model: Vocab):
        self.lang_model = lang_model

    def __len__(self):
        return len(self.store)

    def __getitem__(self, idx: int) -> dict:
        rec = self.store[idx]
        aux_info = rec["aux_info"]
        # np.array copies out of the read-only map
        pose_seq = np.array(rec["pose_seq"], dtype=np.float32)
        pose_seq = pose_seq.reshape(pose_seq.shape[0], -1)
        audio = make_audio_fixed_length(
            np.array(rec["audio"], dtype=np.float32),
            self.expected_audio_length)
        spectrogram = np.array(
            rec["spectrogram"][:, : self.expected_spectrogram_length],
            dtype=np.float32)
        sample = {
            "audio": audio,
            "spectrogram": spectrogram,
            "pose_seq": pose_seq,
            "eid_label": one_hot_eid(aux_info["eid"]),
            "aux_info": aux_info,
        }
        words = rec.get("word_seq", [])
        if self.lang_model is not None:
            duration = aux_info["end_time"] - aux_info["start_time"]
            sample_end_time = (
                aux_info["start_time"]
                + duration * self.n_poses / pose_seq.shape[0])
            sample["text"] = extend_word_seq(
                self.lang_model, words, aux_info, self.n_poses,
                self.remove_word_timing, sample_end_time).astype(np.int32)
            sample["word_tokens"] = words_to_tensor(
                self.lang_model, words, sample_end_time)
        else:
            sample["text"] = np.zeros(self.n_poses, dtype=np.int32)
        return sample

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, rows: slice | None = None,
                native: bool = True, fields=None):
        """`rows` restricts each batch to that slice of its index window
        (multi-host per-process assembly — see SyntheticGestureDataset).
        `fields` restricts which keys are assembled — consumers that drop
        keys anyway (the GAN trainer never reads raw audio — 75% of each
        record's bytes; the FGD trainer only pose_seq) skip the decode
        AND the collate copy for them.

        When the store layout is uniform (probed once; any ragged record
        falls back permanently), batches are assembled through the C++
        batch gather: the big array fields decode straight into the
        stacked output with one copy instead of per-record `__getitem__` +
        `np.stack`, and only the json fields (word_seq/aux_info) are
        decoded per record. Output is value-identical to the per-record
        path; `native=False` forces the reference-shaped exact path."""
        global native_batches, exact_batches
        if rows is not None and not drop_last:
            # a short tail window would slice to ragged/empty per-process
            # batches and desync make_array_from_process_local_data
            # (ADVICE r3)
            raise ValueError("rows= (per-process assembly) requires "
                             "drop_last=True: a tail window shorter than "
                             "batch_size would yield mismatched "
                             "per-process slices")
        want = BATCH_FIELDS if fields is None else tuple(fields)
        # the fast path reimplements exactly THIS class's __getitem__;
        # subclasses with their own sample logic (TED) must stay slow
        fast = (native
                and type(self).__getitem__ is SpeechMotionDataset.__getitem__
                and set(want) <= set(BATCH_FIELDS)
                and self._fast_probe() is not None)
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        end = len(self) - len(self) % batch_size if drop_last else len(self)
        for i in range(0, end, batch_size):
            window = order[i:i + batch_size]
            if rows is not None:
                window = window[rows]
            if fast:
                batch = self._batch_native(window, want)
                if batch is not None:
                    native_batches += 1
                    yield batch
                    continue
                fast = False  # ragged record mid-store: stay exact
            exact_batches += 1
            yield make_batch([self[int(j)] for j in window], want)

    def _fast_probe(self):
        """Shapes that make the native batch path value-identical to
        `__getitem__`: audio already at its fixed length (no pad/trim)
        and a 2-D spectrogram. Probed from record 0 and cached; the
        gather enforces the probe's FULL canonical shape on every record
        of every batch — including each batch's first record — so even a
        batch whose records all deviate identically from the store
        layout falls back to the exact path (ADVICE r4)."""
        probe = getattr(self, "_fast_probe_cache", False)
        if probe is not False:
            return probe
        probe = None
        if len(self.store) > 0:
            rec = self.store[0]
            audio = rec.get("audio")
            spec = rec.get("spectrogram")
            pose = rec.get("pose_seq")
            if (isinstance(audio, np.ndarray)
                    and audio.shape == (self.expected_audio_length,)
                    and isinstance(spec, np.ndarray) and spec.ndim == 2
                    and isinstance(pose, np.ndarray) and pose.ndim >= 2):
                probe = {
                    "n_frames": pose.shape[0],
                    "audio_shape": (self.expected_audio_length,),
                    "spec_shape": spec.shape,
                    "pose_shape": pose.shape,
                }
        self._fast_probe_cache = probe
        return probe

    def _batch_native(self, window, want) -> dict | None:
        """One collated batch via `GestureStore.batch_field` (C++ gather)
        + per-record json metadata, restricted to the `want` fields; None
        when a record's shape disagrees with the probe (caller falls back
        to the exact path)."""
        idx = np.ascontiguousarray(window, dtype=np.int64)
        n = len(idx)
        probe = self._fast_probe()
        n_frames = probe["n_frames"]
        out = {}
        try:
            if "audio" in want:
                out["audio"] = self.store.batch_field(
                    idx, "audio", expected_shape=probe["audio_shape"])
            if "spectrogram" in want:
                out["spectrogram"] = self.store.batch_field(
                    idx, "spectrogram", expected_shape=probe["spec_shape"]
                )[:, :, : self.expected_spectrogram_length]
            if "pose_seq" in want:
                out["pose_seq"] = self.store.batch_field(
                    idx, "pose_seq", expected_shape=probe["pose_shape"]
                ).reshape(n, n_frames, -1)
        except ValueError:
            return None
        need_text = "text" in want and self.lang_model is not None
        if need_text or "eid_label" in want:
            metas = [self.store.json_fields(int(j)) for j in idx]
            if "eid_label" in want:
                out["eid_label"] = np.stack(
                    [one_hot_eid(m["aux_info"]["eid"]) for m in metas])
            if need_text:
                text = np.empty((n, self.n_poses), dtype=np.int32)
                for r, m in enumerate(metas):
                    aux_info = m["aux_info"]
                    duration = (aux_info["end_time"]
                                - aux_info["start_time"])
                    sample_end_time = (aux_info["start_time"]
                                       + duration * self.n_poses / n_frames)
                    text[r] = extend_word_seq(
                        self.lang_model, m.get("word_seq", []), aux_info,
                        self.n_poses, self.remove_word_timing,
                        sample_end_time)
                out["text"] = text
        if "text" in want and self.lang_model is None:
            out["text"] = np.zeros((n, self.n_poses), dtype=np.int32)
        return out


class TedSpeechMotionDataset(SpeechMotionDataset):
    """TED / TED-expressive variant (data_loader/lmdb_data_loader.py:58-199,
    lmdb_data_loader_expressive.py:58-231): dir-vec sequences normalised by
    a mean vector, on-the-fly cache creation from a raw-clip store when the
    sample cache is missing."""

    def __init__(self, data_dir, n_poses: int = 34,
                 subdivision_stride: int = 10,
                 pose_resampling_fps: int = 15,
                 mean_dir_vec=None, mean_pose=None,
                 speaker_model=None, remove_word_timing: bool = False,
                 disable_filtering: bool = False):
        self.mean_dir_vec = (
            None if mean_dir_vec is None
            else np.asarray(mean_dir_vec).reshape(1, -1))
        self.mean_pose = mean_pose
        cache_dir = Path(str(data_dir) + "_cache")
        if not cache_dir.exists():
            # create the cache from the raw clip store on the fly
            # (lmdb_data_loader.py:76-86)
            from .preprocessing import DataPreprocessor

            DataPreprocessor(
                data_dir, cache_dir, n_poses, subdivision_stride,
                pose_resampling_fps, mean_pose=mean_pose,
                mean_dir_vec=mean_dir_vec,
                disable_filtering=disable_filtering,
            ).run()
        super().__init__(data_dir, n_poses, subdivision_stride,
                         pose_resampling_fps, speaker_model,
                         remove_word_timing)

    @classmethod
    def expressive(cls, data_dir, **kwargs):
        """TED-expressive configuration: the 43-joint mean tables inlined
        at lmdb_data_loader_expressive.py:239-260 (vendored in
        data/expressive_constants.py) as the normalisation vectors; the
        126-d mean selects the 43-joint dir-vec pairs in preprocessing,
        and the expressive variant runs the motion filters OFF
        (data_preprocessor_expressive semantics)."""
        from .expressive_constants import (EXPRESSIVE_MEAN_DIR_VEC,
                                           EXPRESSIVE_MEAN_POSE)

        kwargs.setdefault("mean_dir_vec", EXPRESSIVE_MEAN_DIR_VEC)
        kwargs.setdefault("mean_pose", EXPRESSIVE_MEAN_POSE)
        kwargs.setdefault("disable_filtering", True)
        return cls(data_dir, **kwargs)

    def __getitem__(self, idx: int) -> dict:
        sample = super().__getitem__(idx)
        rec = self.store[idx]
        if "vec_seq" in rec:
            sample["vec_seq"] = np.array(rec["vec_seq"], np.float32)
        else:
            from ..ops.pose import (DIR_VEC_PAIRS, DIR_VEC_PAIRS_EXPRESSIVE,
                                    convert_pose_seq_to_dir_vec)

            # pick the pair table matching the mean vector (126-d = the
            # 43-joint expressive layout), as the preprocessor does
            pairs = (DIR_VEC_PAIRS_EXPRESSIVE
                     if self.mean_dir_vec is not None
                     and self.mean_dir_vec.size == 126 else DIR_VEC_PAIRS)
            T = sample["pose_seq"].shape[0]
            vec = convert_pose_seq_to_dir_vec(
                sample["pose_seq"].reshape(T, -1, 3),
                pairs=pairs).reshape(T, -1)
            if self.mean_dir_vec is not None:
                vec = vec - self.mean_dir_vec
            sample["vec_seq"] = vec.astype(np.float32)
        return sample
