"""Shared parts of tests/test_torch_port_migration*.py: the objects the
pyarrow-0.14 codecs are held to, and reference-format LMDBs (BEAT windows,
TED windows, raw clips) written with a given `serialize` and the fixture
writer tests/fixtures/make_lmdb_fixture.py. Made from a numpy seed. This
module imports no JAX: a subprocess with `flatbuffers` blocked imports it.
"""
import sys
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parent / "fixtures"
sys.path.insert(0, str(FIXTURES))
from make_lmdb_fixture import write_lmdb  # noqa: E402

sys.path.pop(0)


def _arrays(rng):
    return [rng.randn(3, 4).astype(np.float16),
            rng.randn(5).astype(np.float32),
            rng.randn(2, 3, 2),  # float64
            np.arange(6, dtype=np.int64).reshape(2, 3)]


# name -> object, from RandomState(seed): what tests/test_arrow014.py
# covers, and the reference caches' value kinds
OBJECTS = {
    "scalars": lambda rng: ["s", 7, -3, 2.5, True, False, b"\x00\x01raw",
                            np.int64(-9), np.float64(0.125)],
    "nested": lambda rng: [1, [2, ["deep", 0.5]], ("a", 1, ("b", [2.0])),
                           {"k": [1, 2], "j": "v", "d": {"x": (1, "y")}}],
    "set": lambda rng: {3, 1, 2},
    "unicode": lambda rng: ["ünïcödé", "", "語"],
    "arrays": _arrays,
    "int_dtypes": lambda rng: [(rng.randn(5, 7) * 10).astype(d) for d in (
        "int8", "int16", "int32", "uint8", "uint32")],
    "bool_array": lambda rng: [rng.rand(9) > 0.5],
    "array_0d_1d": lambda rng: [np.float32(3.25).reshape(()),
                                rng.randn(11).astype(np.float32)],
    "non_contiguous": lambda rng: [rng.randn(6, 8).astype(np.float32)[::2,
                                                                       1::3]],
    "empty": lambda rng: [[], (), {}, np.zeros((0, 3), np.float32)],
    "beat_window": lambda rng: beat_window(rng, 0),
    "ted_window": lambda rng: ted_window(rng, 0),
    "clip_video": lambda rng: clip_video(rng, 0, n_clips=2),
}


def make_object(name, seed=0):
    return OBJECTS[name](np.random.RandomState(seed))


def beat_window(rng, i, audio_len=64000):
    """A BEAT cache value, the 5-tuple of lmdb_loader_BEAT_full.py:171-180,
    at BEAT's shapes."""
    eid = 65 + i % 54
    word_seq = [[f"w{j}", 0.3 * j, 0.3 * j + 0.2] for j in range(3 + i % 5)]
    return [word_seq, rng.randn(60, 282).astype(np.float32),
            rng.randn(audio_len).astype(np.float32),
            (20 * rng.rand(128, 128) - 60).astype(np.float16),
            {"vid": f"v{i}", "eid": f"1_wayne_0_{eid}_{eid}",
             "start_frame_no": 30 * i, "end_frame_no": 30 * i + 60,
             "start_time": 2.0 * i, "end_time": 2.0 * i + 4.0}]


def ted_window(rng, i):
    """A TED cache value, the 6-tuple of lmdb_data_loader.py:104-113 with
    vec_seq third, at TED's shapes (34 frames, 10 joints, 9 dir-vecs)."""
    word_seq = [[f"t{j}", 0.4 * j, 0.4 * j + 0.3] for j in range(2 + i % 4)]
    return [word_seq, rng.randn(34, 10, 3).astype(np.float32),
            rng.randn(34, 9, 3).astype(np.float32),
            rng.randn(36267).astype(np.float32),
            (20 * rng.rand(128, 70) - 60).astype(np.float16),
            {"vid": f"ted{i}", "start_frame_no": 34 * i,
             "end_frame_no": 34 * i + 34, "start_time": 1.36 * i,
             "end_time": 1.36 * i + 1.36}]


def clip_video(rng, i, n_clips=2, n_frames=45, n_joints=10):
    """A raw clip LMDB value (data_preprocessor.py:44-75): one video with
    its clips nested, each with skeletons, a float16 spectrogram, raw audio
    and timed words."""
    clips = []
    for c in range(n_clips):
        n_audio = n_frames * 16000 // 15
        clip = {"skeletons_3d": rng.randn(n_frames, n_joints, 3).astype(
                    np.float32),
                "audio_feat": rng.randn(128, n_audio // 512 + 1).astype(
                    np.float16),
                "audio_raw": rng.randn(n_audio).astype(np.float32),
                "words": [[f"w{k}", 0.3 * k, 0.3 * k + 0.2]
                          for k in range(5)],
                "start_frame_no": 100 * c, "end_frame_no": 100 * c + n_frames,
                "start_time": 10.0 * c, "end_time": 10.0 * c + 3.0}
        if c % 2 == 0:
            clip["eid"] = f"1_wayne_0_{65 + i}_{65 + i}"
        clips.append(clip)
    return {"vid": f"video{i}", "clips": clips}


def write_cache_lmdb(path, serialize, kind, n, seed=0):
    """A reference LMDB of `n` values of `kind` ("beat", "ted", "clips"),
    keys 0000000000, ... as the reference's caches number them."""
    rng = np.random.RandomState(seed)
    make = {"beat": lambda i: beat_window(rng, i, 16000 + 4000 * i),
            "ted": lambda i: ted_window(rng, i),
            "clips": lambda i: clip_video(rng, i, n_clips=1 + i % 2)}[kind]
    write_lmdb(path, {f"{i:010d}".encode(): serialize(make(i))
                      for i in range(n)})
    return path


def assert_same(a, b, path="obj"):
    """Two decoded objects: the same types, containers and values; arrays
    of the same dtype, shape and bytes."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)
