"""Shared helpers of the real-data parity tests (tests/test_torch_port_data*.py,
tests/test_torch_port_preprocessing.py): clip stores and window stores made
from a numpy seed, written with the JAX package's writer (the tests hold the
two writers to the same bytes)."""
import numpy as np

from emotiongestures_tpu.data.store import GestureStoreWriter

EIDS = (1, 65, 73, 81, 87, 95, 103, 111)  # one per emotion range


def make_clip(rng, i=0, n_frames=150, fps=15, n_joints=10, n_mels=128,
              audio_feat=True):
    """One clip record as the preprocessor reads it: a lively skeleton with
    an upright spine, speech-rate timed words, raw audio and (optionally)
    a precomputed spectrogram."""
    duration = n_frames / fps
    t = np.arange(n_frames)[:, None] / fps
    skel = np.zeros((n_frames, n_joints, 3))
    skel[:, 1, 1] = -0.5  # spine pointing down (towards -y)
    # the limbs swing; root and spine stay put
    skel[:, 2:] += 0.3 * np.sin(
        2 * np.pi * rng.uniform(0.5, 1.5, (1, n_joints - 2, 3))
        * t[:, :, None] + rng.uniform(0, 6, (1, n_joints - 2, 3)))
    skel += 0.01 * rng.randn(*skel.shape)
    n_audio = int(duration * 16000)
    spec_len = int(round((n_audio - 1024) / 512 + 1))
    starts = np.arange(0.05, duration - 0.3, 0.3) + rng.uniform(0, 0.05)
    eid = EIDS[i % 8]
    clip = {
        "skeletons_3d": skel.astype(np.float32),
        "audio_raw": (0.1 * rng.randn(n_audio)).astype(np.float32),
        "words": [[f"w{rng.randint(12)}", float(s), float(s + 0.2)]
                  for s in starts],
        "aux_info": {
            "vid": f"vid{i}",
            "eid": f"1_wayne_0_{eid}_{eid}",
            "start_frame_no": 0,
            "end_frame_no": n_frames,
            "start_time": 0.0,
            "end_time": duration,
        },
    }
    if audio_feat:
        clip["audio_feat"] = rng.randn(n_mels, spec_len).astype(np.float16)
    return clip


def write_clip_store(path, n_clips, seed=0, **kw):
    rng = np.random.RandomState(seed)
    with GestureStoreWriter(path) as w:
        for i in range(n_clips):
            w.append(make_clip(rng, i, **kw))


def window_record(rng, i, audio_len=64000, pose=(60, 282)):
    """One window record in the BEAT cache layout."""
    eid = 65 + i % 54
    return {
        "word_seq": [[f"w{j}", 0.3 * j, 0.3 * j + 0.2]
                     for j in range(3 + i % 5)],
        "pose_seq": rng.randn(*pose).astype(np.float32),
        "audio": rng.randn(audio_len).astype(np.float32),
        "spectrogram": rng.randn(128, 128).astype(np.float16),
        "aux_info": {"eid": f"1_wayne_0_{eid}_{eid}",
                     "start_time": 0.0, "end_time": 4.0},
    }


def write_window_store(path, n, seed=0, audio_len=lambda i: 64000):
    rng = np.random.RandomState(seed)
    with GestureStoreWriter(path) as w:
        for i in range(n):
            w.append(window_record(rng, i, audio_len(i)))


def assert_records_equal(a, b, spec_atol=None):
    """Two decoded records: the same keys and values (the spectrogram
    within `spec_atol` when given)."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if k == "spectrogram" and spec_atol is not None:
                np.testing.assert_allclose(a[k].astype(np.float32),
                                           b[k].astype(np.float32),
                                           atol=spec_atol, err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
