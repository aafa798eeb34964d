"""GestureStore: the memory-mapped record store that replaces the
reference's LMDB sample caches (data_loader/lmdb_loader_BEAT_full.py:
153-156); the port of emotiongestures_tpu/data/store.py.

Layout on disk (directory):
  data.bin    append-only concatenation of EGTP records (data/codec.py)
  index.npy   int64 (n+1,) record byte offsets (offsets[i]..offsets[i+1])

Readers mmap data.bin; `__getitem__` decodes zero-copy ndarray views into
the read-only map. `batch_field` gathers one field of many records into a
stacked float32 array through the C++ batch gather `csrc/codec.cpp`, which
is built with g++ at first use into `emotiongestures_torch/_build/` under a
name that carries a hash of the source and the flags. A failed build or
load raises with the compiler's output: the port never falls back to the
Python loop without being asked (`native=False`).

The converters from the reference's LMDB caches (`convert_lmdb_cache`,
windows; `convert_clip_lmdb`, raw clips) read the LMDB container with the
port's pure-Python reader (data/lmdb_reader.py), or with the `lmdb` package
where it imports, and decode the pyarrow-0.14 payloads with the port's own
reader (data/arrow014.py): neither `lmdb` nor `pyarrow` is needed. They
write the JAX package's converters' stores byte for byte.
"""
from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .arrow014 import deserialize
from .codec import decode_json_fields, decode_record, encode_record

PACKAGE = Path(__file__).resolve().parent.parent
CODEC_SRC = PACKAGE / "csrc" / "codec.cpp"
BUILD_DIR = PACKAGE / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-pthread"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# argtypes of csrc/codec.cpp's exports (as the JAX package binds them)
_SIGNATURES = {
    "egtp_batch_gather_f32": [_P, _P, _P, _LL, ctypes.c_char_p, _P, _LL, _I],
    "egtp_batch_gather_f32_shaped": [_P, _P, _P, _LL, ctypes.c_char_p, _P,
                                     _P, _I, _I],
    "egtp_field_shape": [_P, _P, _LL, ctypes.c_char_p, _P, _P],
}

_lock = threading.Lock()
_codec: ctypes.CDLL | None = None


def codec_target() -> Path:
    """The shared library's path for this source and these flags."""
    digest = hashlib.sha256(CODEC_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libegtp_codec-{digest}.so"


def build_codec() -> Path:
    """Compile csrc/codec.cpp with g++ unless it is built; raise with the
    compiler's output if that fails."""
    target = codec_target()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's batch gather "
                           "csrc/codec.cpp is built with g++ at first use")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(CODEC_SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for csrc/codec.cpp:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, target)
    return target


def native_codec() -> ctypes.CDLL:
    """The loaded batch gather, built first if needed."""
    global _codec
    with _lock:
        if _codec is None:
            lib = ctypes.CDLL(str(build_codec()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _codec = lib
    return _codec


class GestureStoreWriter:
    """Atomic store writer: records stream into `<path>.tmp-<pid>` and the
    directory is renamed onto `path` only on clean close. An exception
    inside the `with` block (e.g. the preprocessor's NaN guard) aborts and
    removes the temp dir, so a dataset's `cache_dir.exists()` check can
    never see a truncated half-written cache as complete."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._tmp = Path(f"{self.path}.tmp-{os.getpid()}")
        self._tmp.mkdir(parents=True, exist_ok=True)
        self._data = open(self._tmp / "data.bin", "wb")
        self._offsets = [0]
        self._done = False

    def append(self, record: dict):
        buf = encode_record(record)
        self._data.write(buf)
        self._offsets.append(self._offsets[-1] + len(buf))

    def close(self):
        """Commit: finalize the index and atomically publish the dir."""
        if self._done:
            return
        self._data.close()
        np.save(self._tmp / "index.npy",
                np.asarray(self._offsets, dtype=np.int64))
        if self.path.exists():  # overwrite semantics (rebuilding a cache)
            shutil.rmtree(self.path)
        os.rename(self._tmp, self.path)
        self._done = True

    def abort(self):
        """Discard everything written so far; leaves `path` untouched."""
        if self._done:
            return
        self._data.close()
        shutil.rmtree(self._tmp, ignore_errors=True)
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()


class GestureStore:
    """Read-only mmap view over a GestureStoreWriter output."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.offsets = np.load(self.path / "index.npy")
        self._file = open(self.path / "data.bin", "rb")
        size = self.offsets[-1]
        self._mmap = (
            mmap.mmap(self._file.fileno(), size, access=mmap.ACCESS_READ)
            if size
            else b""
        )
        self._view = memoryview(self._mmap)

    def __len__(self):
        return len(self.offsets) - 1

    def __getitem__(self, idx: int) -> dict:
        """Record `idx`; its arrays are read-only views into the map."""
        lo, hi = int(self.offsets[idx]), int(self.offsets[idx + 1])
        return decode_record(self._view[lo:hi])

    def json_fields(self, idx: int) -> dict:
        """Only the json-kind fields (aux_info, word_seq) of record `idx`:
        skips ndarray payloads entirely; pairs with `batch_field` for the
        fast batch-assembly path."""
        lo, hi = int(self.offsets[idx]), int(self.offsets[idx + 1])
        return decode_json_fields(self._view[lo:hi])

    def batch_field(self, indices, name: str, n_threads: int = 0,
                    expected_shape=None, native: bool = True) -> np.ndarray:
        """Gather field `name` of many records into one (n, *shape) f32
        array (a new array, never a view of the map): the host hot path,
        through the multithreaded C++ gather, or the per-record Python loop
        with `native=False`.

        `expected_shape` pins the canonical per-record shape (e.g. the
        dataset probe's record-0 layout): EVERY record, the batch's first
        included, must match it exactly or ValueError is raised, so a batch
        whose records all deviate identically cannot be returned silently
        un-fixed-up. Without it the batch's first record defines the
        shape."""
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        n = len(indices)
        if n == 0:
            raise ValueError("empty index list")
        if expected_shape is None:
            shape = tuple(self[int(indices[0])][name].shape)
        else:
            shape = tuple(int(s) for s in expected_shape)
        out = np.empty((n,) + shape, dtype=np.float32)
        if native and len(self._view) > 0:
            lib = native_codec()
            # zero-copy address of the (read-only) map via numpy
            base = np.frombuffer(self._mmap, dtype=np.uint8)
            args = (base.ctypes.data, self.offsets.ctypes.data,
                    indices.ctypes.data, n, name.encode(), out.ctypes.data)
            if expected_shape is not None:
                cshape = np.asarray(shape, dtype=np.int64)
                rc = lib.egtp_batch_gather_f32_shaped(
                    *args, cshape.ctypes.data, len(shape), n_threads)
            else:
                rc = lib.egtp_batch_gather_f32(
                    *args, int(np.prod(shape)), n_threads)
            if rc == 0:
                return out
            raise ValueError(
                f"native decode failed at batch position {-rc - 1}")
        for i, idx in enumerate(indices):
            arr = np.asarray(self[int(idx)][name], dtype=np.float32)
            if arr.shape != shape:
                raise ValueError(
                    f"record {int(idx)} field {name!r} shape {arr.shape} "
                    f"!= expected {shape}")
            out[i] = arr
        return out

    def close(self):
        """Best-effort close: decoded records hold zero-copy views into the
        map, which keep it alive until they are garbage-collected."""
        try:
            self._view.release()
            if self._mmap:
                self._mmap.close()
        except BufferError:
            pass
        self._file.close()


def _iter_lmdb(lmdb_dir: str):
    """(key, value) pairs from a reference LMDB env, in key order. The
    `lmdb` package is preferred where it imports, as the reference's own
    implementation of the format; otherwise the pure-Python reader
    (data/lmdb_reader.py) parses the file."""
    try:
        import lmdb  # optional
    except ImportError:
        from .lmdb_reader import iter_entries

        yield from iter_entries(lmdb_dir)
        return
    env = lmdb.open(str(lmdb_dir), readonly=True, lock=False)
    try:
        with env.begin() as txn:
            for key, value in txn.cursor():
                yield bytes(key), bytes(value)
    finally:
        env.close()


def window_record_from_serialized(buf) -> dict:
    """One pyarrow-0.14-serialized cache value -> GestureStore record, for
    both reference layouts:
      BEAT 5-tuple (word_seq, pose_seq, audio, spectrogram, aux_info):
        lmdb_loader_BEAT_full.py:171-180
      TED 6-tuple with vec_seq inserted third: lmdb_data_loader.py:104-113
    """
    sample = deserialize(buf)
    if len(sample) == 5:
        word_seq, pose_seq, audio, spectrogram, aux_info = sample
        vec_seq = None
    elif len(sample) == 6:
        word_seq, pose_seq, vec_seq, audio, spectrogram, aux_info = sample
    else:
        raise ValueError(
            f"unrecognized cache record layout ({len(sample)} fields)")
    record = {
        "word_seq": [list(w) for w in word_seq],
        "pose_seq": np.asarray(pose_seq),
        "audio": np.asarray(audio),
        "spectrogram": np.asarray(spectrogram),
        "aux_info": dict(aux_info),
    }
    if vec_seq is not None:
        record["vec_seq"] = np.asarray(vec_seq)
    return record


def convert_lmdb_cache(lmdb_dir: str, out_dir: str):
    """A reference window cache (LMDB of pyarrow-0.14 values) -> a
    GestureStore at `out_dir`, one record per window in key order."""
    with GestureStoreWriter(out_dir) as writer:
        for _, value in _iter_lmdb(lmdb_dir):
            writer.append(window_record_from_serialized(value))


def convert_clip_lmdb(lmdb_dir: str, out_dir: str):
    """A reference RAW clip LMDB (one video with nested clips per record,
    data_preprocessor.py:44-75) -> the flat one-record-per-clip store that
    preprocessing.DataPreprocessor reads."""
    with GestureStoreWriter(out_dir) as writer:
        for _, value in _iter_lmdb(lmdb_dir):
            video = deserialize(value)
            vid = video["vid"]
            for clip in video["clips"]:
                writer.append({
                    "skeletons_3d": np.asarray(clip["skeletons_3d"]),
                    "audio_feat": np.asarray(clip["audio_feat"]),
                    "audio_raw": np.asarray(clip["audio_raw"]),
                    "words": [list(w) for w in clip["words"]],
                    "aux_info": {
                        "vid": vid,
                        "eid": clip.get("eid", vid),
                        "start_frame_no": int(clip["start_frame_no"]),
                        "end_frame_no": int(clip["end_frame_no"]),
                        "start_time": float(clip["start_time"]),
                        "end_time": float(clip["end_time"]),
                    },
                })
