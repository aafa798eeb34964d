"""The port's DataPreprocessor against the JAX package's, on the CPU, over
one clip store: "precomputed" and "numpy" give the same records (the same
store bytes); "xla" (the plain PyTorch mel) against JAX "xla", and "pallas"
on a CPU device (the mel kernel's plain version) against JAX "pallas" in
interpret mode, hold every window's float16 log-mel within 0.08 dB, the
JAX package's own frontend tolerance (tests/test_preprocessing.py:116-160),
with every other field equal. Also the TED-expressive 43-joint case with
`vec_seq`, the motion filters and the NaN guard."""
import numpy as np
import pytest

from emotiongestures_torch.data import preprocessing as PP
from emotiongestures_torch.data.store import GestureStore, GestureStoreWriter
from emotiongestures_torch.ops import fused_mel as FM
from emotiongestures_tpu.data import preprocessing as JP
from emotiongestures_tpu.data.store import GestureStore as JaxStore
from torch_port_data_common import assert_records_equal, write_clip_store

SPEC_ATOL = 0.08  # dB


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two clips of 10 s (4 windows each), with audio_feat."""
    path = tmp_path_factory.mktemp("clips") / "clips"
    write_clip_store(path, 2, seed=0)
    return path


def _run(module, clips, out, frontend, **kw):
    pre = module.DataPreprocessor(clips, out, n_poses=60,
                                  subdivision_stride=30,
                                  pose_resampling_fps=15,
                                  spectrogram_frontend=frontend, **kw)
    if module is JP:
        pre._pallas_interpret = True  # the JAX package's CPU route
    return pre.run()


@pytest.mark.parametrize("frontend", ["precomputed", "numpy"])
def test_host_frontends_write_the_jax_records(clips, tmp_path, frontend):
    got = _run(PP, clips, tmp_path / "p", frontend)
    want = _run(JP, clips, tmp_path / "j", frontend)
    assert got == want and want[1] == 8
    for f in ("data.bin", "index.npy"):
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


@pytest.mark.parametrize("frontend", ["xla", "pallas"])
def test_device_frontends_match_jax(clips, tmp_path, frontend):
    launches = FM.launches
    got = _run(PP, clips, tmp_path / "p", frontend, device="cpu")
    want = _run(JP, clips, tmp_path / "j", frontend)
    assert FM.launches == launches  # a CPU tensor takes the plain version
    assert got == want and want[1] == 8
    p, j = GestureStore(tmp_path / "p"), JaxStore(tmp_path / "j")
    for i in range(len(j)):
        assert p[i]["spectrogram"].dtype == np.float16
        assert p[i]["spectrogram"].shape == (128, 124)
        assert_records_equal(p[i], j[i], spec_atol=SPEC_ATOL)
    p.close()
    j.close()


def test_device_frontends_need_a_device(clips, tmp_path):
    """"xla" and "pallas" run on the card unless the CPU is asked for; the
    host frontends touch no device."""
    import torch

    for frontend in ("precomputed", "numpy"):
        pre = PP.DataPreprocessor(clips, tmp_path / frontend, 60, 30, 15,
                                  spectrogram_frontend=frontend)
        assert pre.device is None
    if not torch.cuda.is_available():
        for frontend in ("xla", "pallas"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                PP.DataPreprocessor(clips, tmp_path / frontend, 60, 30, 15,
                                    spectrogram_frontend=frontend)
    with pytest.raises(ValueError, match="frontend"):
        PP.DataPreprocessor(clips, tmp_path / "x", 60, 30, 15,
                            spectrogram_frontend="librosa")


def test_precomputed_needs_audio_feat(tmp_path):
    write_clip_store(tmp_path / "clips", 1, audio_feat=False)
    with pytest.raises(KeyError, match="audio_feat"):
        _run(PP, tmp_path / "clips", tmp_path / "out", "precomputed")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("layout", ["ted", "expressive"])
def test_dir_vec_layouts_match_jax(tmp_path, layout):
    """vec_seq in the TED 10-joint layout with the motion filters on (the
    windows they reject kept, as disable_filtering does), and in the
    TED-expressive 43-joint layout (filters off, pass-through)."""
    from emotiongestures_torch.data.expressive_constants import (
        EXPRESSIVE_MEAN_DIR_VEC,
        EXPRESSIVE_MEAN_POSE,
    )

    n_joints = 43 if layout == "expressive" else 10
    write_clip_store(tmp_path / "clips", 2, seed=2, n_frames=90,
                     n_joints=n_joints)
    if layout == "expressive":
        kw = dict(mean_pose=EXPRESSIVE_MEAN_POSE,
                  mean_dir_vec=EXPRESSIVE_MEAN_DIR_VEC)
    else:
        mean_pose = np.zeros((10, 3))
        mean_pose[1, 1] = -0.5
        kw = dict(mean_pose=mean_pose,
                  mean_dir_vec=np.full(27, 0.1), disable_filtering=True)
    results = []
    for module, out in ((PP, "p"), (JP, "j")):
        pre = module.DataPreprocessor(tmp_path / "clips", tmp_path / out,
                                      n_poses=34, subdivision_stride=10,
                                      pose_resampling_fps=15, **kw)
        assert pre.filters_pass_through == (layout == "expressive")
        results.append(pre.run())
    assert results[0] == results[1] and results[0][1] > 0
    for f in ("data.bin", "index.npy"):
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    rec = GestureStore(tmp_path / "p")[0]
    assert rec["vec_seq"].shape == (34, 126 if layout == "expressive" else 27)


def test_nan_guard_discards_the_cache(tmp_path):
    skel = np.zeros((40, 43, 3), np.float32)
    skel[7, 5, 1] = np.nan
    with GestureStoreWriter(tmp_path / "clips") as w:
        w.append({
            "skeletons_3d": skel,
            "audio_feat": np.zeros((128, 90), np.float16),
            "audio_raw": np.zeros(16000 * 2, np.float32),
            "words": [["hi", 0.1, 0.5], ["there", 0.6, 1.4]],
            "aux_info": {"vid": "v0", "eid": "1_x_0_65_65",
                         "start_time": 0.0, "end_time": 40 / 15},
        })
    pre = PP.DataPreprocessor(tmp_path / "clips", tmp_path / "out",
                              n_poses=34, subdivision_stride=10,
                              pose_resampling_fps=15,
                              mean_dir_vec=np.zeros(126, np.float32),
                              convert_to_dir_vec=False)
    with pytest.raises(ValueError, match="missing joints"):
        pre.run()
    assert not (tmp_path / "out").exists()
    assert [p.name for p in tmp_path.iterdir()] == ["clips"]


def test_motion_filters_and_word_ranges_match_jax():
    mean_pose = np.zeros((10, 3))
    mean_pose[1, 1] = -0.5
    t = np.arange(60)[:, None, None] / 15
    limbs = np.arange(10)[None, :, None] >= 2
    upright = np.broadcast_to(mean_pose, (60, 10, 3))
    tilted = upright + limbs * 1.0
    tilted[:, 1] = [0.5, -0.1, 0.0]
    cases = [upright,                                      # near the mean
             tilted,                                       # spine angle
             upright + limbs * 1.0,                        # static arms
             upright + limbs * 0.5 * np.sin(2 * np.pi * t + np.arange(3))]
    for skel in cases:
        got = PP.MotionPreprocessor(skel, mean_pose).get()
        want = JP.MotionPreprocessor(skel, mean_pose).get()
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    assert {PP.MotionPreprocessor(s, mean_pose).get()[1] for s in cases} \
        == {"pose", "spine angle", "motion", "PASS"}
    words = [["a", 0.0, 0.5], ["b", 0.6, 1.0], ["c", 1.5, 2.0]]
    for lo, hi in ((0.4, 1.2), (0.0, 0.1), (1.0, 3.0)):
        assert PP.get_words_in_time_range(words, lo, hi) == \
            JP.get_words_in_time_range(words, lo, hi)
