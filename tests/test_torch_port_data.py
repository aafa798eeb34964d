"""The port's real-data stack against the JAX package, on the CPU: the
record codec and GestureStore (byte for byte, read across), the C++ batch
gather (the port's own build), the vocabulary and its pickles, the pose ops,
Human3.6M, the audio ops and both datasets' samples and batches. Stores
hold a few records each."""
import io
import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from emotiongestures_torch.data import codec as PC
from emotiongestures_torch.data import dataset as PD
from emotiongestures_torch.data import store as PS
from emotiongestures_torch.data import synthetic as PSyn
from emotiongestures_torch.data import vocab as PV
from emotiongestures_torch.ops import pose as PP
from emotiongestures_tpu.data import codec as JC
from emotiongestures_tpu.data import dataset as JD
from emotiongestures_tpu.data import store as JS
from emotiongestures_tpu.data import synthetic as JSyn
from emotiongestures_tpu.data import vocab as JV
from emotiongestures_tpu.ops import pose as JP
from torch_port_data_common import (
    assert_batches_equal,
    assert_records_equal,
    window_record,
    write_clip_store,
    write_window_store,
)

REPO = Path(__file__).resolve().parent.parent


def _records(seed=0, n=4):
    rng = np.random.RandomState(seed)
    recs = [window_record(rng, i, audio_len=1000, pose=(6, 4, 3))
            for i in range(n)]
    recs[1]["vec_seq"] = rng.randn(6, 9).astype(np.float64)
    recs[2]["scalar"] = np.array(2.5, np.float32)  # a 0-d array
    recs[3]["ids"] = np.arange(5, dtype=np.int64)
    return recs


# ---------------------------------------------------------------------------
# codec and store
# ---------------------------------------------------------------------------

def test_codec_bytes_and_decode_match_jax():
    for rec in _records():
        buf = PC.encode_record(rec)
        assert buf == JC.encode_record(rec)
        assert_records_equal(PC.decode_record(buf), JC.decode_record(buf))
        assert PC.decode_json_fields(buf) == JC.decode_json_fields(buf)
    with pytest.raises(ValueError, match="magic"):
        PC.decode_record(b"XXXX" + bytes(8))


def test_stores_are_byte_identical_and_read_across(tmp_path):
    recs = _records()
    for writer, name in ((PS.GestureStoreWriter, "port"),
                         (JS.GestureStoreWriter, "jax")):
        with writer(tmp_path / name) as w:
            for r in recs:
                w.append(r)
    for f in ("data.bin", "index.npy"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    for reader, name in ((PS.GestureStore, "jax"), (JS.GestureStore, "port")):
        store = reader(tmp_path / name)
        assert len(store) == len(recs)
        for i, r in enumerate(recs):
            assert_records_equal(store[i], r)
            assert store.json_fields(i) == {k: v for k, v in r.items()
                                            if not isinstance(v, np.ndarray)}
        store.close()


def test_store_writer_aborts_on_exception(tmp_path):
    target = tmp_path / "cache"
    with PS.GestureStoreWriter(target) as w:
        w.append({"x": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError):
        with PS.GestureStoreWriter(target) as w:
            w.append({"x": np.ones(3, np.float32)})
            raise RuntimeError("interrupted")
    store = PS.GestureStore(target)  # the old cache stands
    assert len(store) == 1 and store[0]["x"].shape == (2,)
    store.close()
    assert [p.name for p in tmp_path.iterdir()] == ["cache"]


@pytest.fixture(scope="module")
def gather_store(tmp_path_factory):
    path = tmp_path_factory.mktemp("gather") / "cache"
    rng = np.random.RandomState(0)
    with PS.GestureStoreWriter(path) as w:
        for i in range(12):
            w.append({
                "word_seq": [["hi", 0.1, 0.2]],
                "pose_seq": rng.randn(5, 6).astype(np.float32),
                "spectrogram": rng.randn(4, 7).astype(np.float16),
                "wide": rng.randn(3).astype(np.float64),
                "ids": rng.randint(0, 9, 3).astype(np.int32),
                # record 7 deviates: same element count, another shape
                "audio": rng.randn(*((5, 4) if i == 7 else (4, 5)))
                .astype(np.float32),
            })
    store = PS.GestureStore(path)
    yield store
    store.close()


@pytest.mark.parametrize("field", ["pose_seq", "spectrogram", "wide", "ids"])
def test_native_gather_matches_python_path(gather_store, field):
    idx = np.array([3, 0, 11, 5, 5])
    got = gather_store.batch_field(idx, field, n_threads=3)
    want = gather_store.batch_field(idx, field, native=False)
    assert got.dtype == np.float32 and got.flags.writeable
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.stack([gather_store[int(i)][field] for i in idx])
        .astype(np.float32))


def test_native_gather_refuses_missing_and_deviant(gather_store):
    with pytest.raises(ValueError, match="native decode failed"):
        gather_store.batch_field([0, 1], "missing",
                                 expected_shape=(4, 5))
    # unshaped: record 7's element count matches, so it passes
    gather_store.batch_field([6, 7], "audio")
    with pytest.raises(ValueError, match="batch position 1"):
        gather_store.batch_field([6, 7], "audio", expected_shape=(4, 5))
    with pytest.raises(ValueError, match="shape"):
        gather_store.batch_field([6, 7], "audio", expected_shape=(4, 5),
                                 native=False)


def test_failed_codec_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(PS, "CODEC_SRC", bad)
    monkeypatch.setattr(PS, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        PS.build_codec()
    assert not list((tmp_path / "_build").iterdir())


def test_materialize_store_bytes_match_jax(tmp_path):
    PSyn.materialize_store(tmp_path / "p", 3, seed=2)
    JSyn.materialize_store(tmp_path / "j", 3, seed=2)
    for f in ("data.bin", "index.npy"):
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


# ---------------------------------------------------------------------------
# vocabulary and its pickles
# ---------------------------------------------------------------------------

def _fill(vocab_cls, weights_path=None):
    v = vocab_cls("words")
    for w in "the cat sat on the mat the end".split():
        v.index_word(w)
    if weights_path is not None:
        v.load_word_vectors(weights_path, embedding_dim=4)
    return v


def _vocab_fields(v):
    return (v.name, v.trimmed, v.word2index, v.word2count, v.index2word,
            v.n_words)


def test_vocab_semantics_match_jax(tmp_path):
    np.savez(tmp_path / "vec.npz", words=np.array(["cat", "mat", "zzz"]),
             vectors=np.arange(12, dtype=np.float32).reshape(3, 4))
    p, j = _fill(PV.Vocab, tmp_path / "vec.npz"), \
        _fill(JV.Vocab, tmp_path / "vec.npz")
    assert _vocab_fields(p) == _vocab_fields(j)
    np.testing.assert_array_equal(p.word_embedding_weights,
                                  j.word_embedding_weights)
    assert p.get_word_index("dog") == j.get_word_index("dog") == 3
    p.trim(2)
    j.trim(2)
    assert _vocab_fields(p) == _vocab_fields(j)
    (tmp_path / "glove.txt").write_text(
        "cat 1 2 3 4\nthe 0.5 0.5 0.5\nthe 9 9 9 9\nbad x y z w\n")
    for v in (p, j):
        v.load_glove_vectors(tmp_path / "glove.txt", embedding_dim=4,
                             use_cache=False)
    np.testing.assert_array_equal(p.word_embedding_weights,
                                  j.word_embedding_weights)


def test_glove_cache_is_shared(tmp_path):
    (tmp_path / "glove.txt").write_text("cat 1 2 3 4\n")
    j = _fill(JV.Vocab)
    j.load_glove_vectors(tmp_path / "glove.txt", embedding_dim=4)
    assert (tmp_path / "glove_cache.pkl").exists()
    (tmp_path / "glove.txt").write_text("")  # only the cache has the row
    p = _fill(PV.Vocab)
    p.load_glove_vectors(tmp_path / "glove.txt", embedding_dim=4)
    np.testing.assert_array_equal(p.word_embedding_weights,
                                  j.word_embedding_weights)


def test_jax_vocab_pickles_load_without_the_jax_package(tmp_path):
    """A vocab_all.pkl and a _speaker_model.pkl written by the JAX package
    load in a process where emotiongestures_tpu cannot be imported."""
    np.save(tmp_path / "vec.npy", np.arange(40, dtype=np.float32)
            .reshape(10, 4))
    j = _fill(JV.Vocab, tmp_path / "vec.npy")
    j.save(tmp_path / "vocab_all.pkl")
    write_window_store(tmp_path / "test_cache", 5)
    speaker = JD.SpeechMotionDataset(tmp_path / "test").speaker_model
    assert (tmp_path / "test_speaker_model.pkl").exists()
    code = (
        "import json, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'emotiongestures_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from emotiongestures_torch.data.dataset import SpeechMotionDataset\n"
        "from emotiongestures_torch.data.vocab import Vocab\n"
        f"v = Vocab.load({str(tmp_path / 'vocab_all.pkl')!r})\n"
        f"s = SpeechMotionDataset({str(tmp_path / 'test')!r}).speaker_model\n"
        "print(json.dumps([[type(x).__module__, x.word2index, "
        "{str(k): w for k, w in x.index2word.items()}, x.n_words] "
        "for x in (v, s)] + [v.word_embedding_weights.tolist()]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    (vmod, w2i, i2w, n), (smod, sw2i, si2w, sn), weights = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert vmod == smod == "emotiongestures_torch.data.vocab"
    assert (w2i, n) == (j.word2index, j.n_words)
    assert i2w == {str(k): w for k, w in j.index2word.items()}
    assert (sw2i, sn) == (speaker.word2index, speaker.n_words)
    assert si2w == {str(k): w for k, w in speaker.index2word.items()}
    np.testing.assert_array_equal(np.asarray(weights, np.float32),
                                  j.word_embedding_weights)


def test_port_vocab_pickle_loads_in_jax(tmp_path):
    np.save(tmp_path / "vec.npy", np.ones((3, 4), np.float32))
    p = _fill(PV.Vocab, tmp_path / "vec.npy")
    p.save(tmp_path / "vocab_all.pkl")
    j = JV.Vocab.load(tmp_path / "vocab_all.pkl")
    assert type(j) is JV.Vocab
    assert _vocab_fields(j) == _vocab_fields(p)
    np.testing.assert_array_equal(j.word_embedding_weights,
                                  p.word_embedding_weights)
    # and back: the port reads what it wrote
    again = PV.Vocab.load(tmp_path / "vocab_all.pkl")
    assert type(again) is PV.Vocab
    assert _vocab_fields(again) == _vocab_fields(p)


def test_vocab_unpickler_refuses_other_globals(tmp_path):
    class Evil:
        def __reduce__(self):
            return (print, ("ran code from a pickle",))

    path = tmp_path / "evil.pkl"
    path.write_bytes(pickle.dumps({"vocab": Evil()}))
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        PV.Vocab.load(path)
    buf = io.BytesIO()
    pickle.dump(torch.zeros(2), buf)  # not numpy: refused too
    path.write_bytes(buf.getvalue())
    with pytest.raises(pickle.UnpicklingError, match="refused"):
        PV.Vocab.load(path)


def test_build_vocab_matches_jax(tmp_path):
    write_window_store(tmp_path / "s", 6)
    p = PV.build_vocab("words", [PS.GestureStore(tmp_path / "s")],
                       tmp_path / "p.pkl")
    j = JV.build_vocab("words", [JS.GestureStore(tmp_path / "s")],
                       tmp_path / "j.pkl")
    assert _vocab_fields(p) == _vocab_fields(j)
    assert (tmp_path / "p.pkl").read_bytes() == \
        (tmp_path / "j.pkl").read_bytes()
    assert _vocab_fields(PV.build_vocab("x", [], tmp_path / "j.pkl")) == \
        _vocab_fields(j)


# ---------------------------------------------------------------------------
# pose ops, Human3.6M, audio ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pairs", ["ted", "expressive"])
def test_pose_ops_match_jax(pairs):
    rng = np.random.RandomState(0)
    pp, jp = ((PP.DIR_VEC_PAIRS, JP.DIR_VEC_PAIRS) if pairs == "ted"
              else (PP.DIR_VEC_PAIRS_EXPRESSIVE, JP.DIR_VEC_PAIRS_EXPRESSIVE))
    assert pp == jp
    n_joints = max(max(a, b) for a, b, _ in pp) + 1
    poses = rng.randn(2, 7, n_joints, 3).astype(np.float32)
    vec = PP.convert_pose_seq_to_dir_vec(poses, pairs=pp)
    np.testing.assert_array_equal(
        vec, JP.convert_pose_seq_to_dir_vec(poses, pairs=jp))
    np.testing.assert_array_equal(
        PP.convert_pose_seq_to_dir_vec(poses.reshape(2, 7, -1), pairs=pp),
        vec)
    np.testing.assert_array_equal(
        PP.convert_dir_vec_to_pose(vec.reshape(2, 7, -1), pairs=pp),
        JP.convert_dir_vec_to_pose(vec.reshape(2, 7, -1), pairs=jp))
    seq = rng.randn(23, n_joints, 3).astype(np.float32)
    got = PP.resample_pose_seq(seq, 2.2, 15)
    assert got.dtype == np.float32 and len(got) == 33
    np.testing.assert_array_equal(got, JP.resample_pose_seq(seq, 2.2, 15))


def test_text_helpers_match_jax():
    for s in ["Hello, World!  It's <b>fine</b>?", "  DON'T stop... 42 "]:
        assert PP.normalize_string(s) == JP.normalize_string(s)
        assert PP.remove_tags_marks(s) == JP.remove_tags_marks(s)
    words = [["a", 1.0, 1.5], ["b", 2.0, 3.0], ["c", 0.5, 0.9]]
    got = PP.time_stretch_for_words([list(w) for w in words], 1.0, 2.0)
    assert got == JP.time_stretch_for_words([list(w) for w in words], 1.0,
                                            2.0)


def test_h36m_matches_jax():
    from emotiongestures_torch.data import h36m as PH
    from emotiongestures_tpu.data import h36m as JH

    rng = np.random.RandomState(0)
    data = {"S1": {"walk": rng.randn(80, 32, 3)},
            "S11": {"sit": rng.randn(70, 32, 3)},
            "S2": {"x": rng.randn(70, 32, 3)}}
    np.testing.assert_array_equal(PH.rotation_matrix([0, 1, 0], 0.3),
                                  JH.rotation_matrix([0, 1, 0], 0.3))
    np.testing.assert_array_equal(
        PH.normalize_h36m(data["S1"]["walk"][:, PH.TARGET_JOINTS]),
        JH.normalize_h36m(data["S1"]["walk"][:, JH.TARGET_JOINTS]))
    mean = rng.randn(27).astype(np.float32)
    for is_train, augment in ((True, True), (False, False)):
        p = PH.Human36M(data, mean, is_train=is_train, augment=augment,
                        n_poses=8, seed=3)
        j = JH.Human36M(data, mean, is_train=is_train, augment=augment,
                        n_poses=8, seed=3)
        assert len(p) == len(j) > 0
        for i in range(len(p)):
            for a, b in zip(p[i], j[i]):
                np.testing.assert_array_equal(a, b)


def test_audio_ops_match_jax():
    import jax.numpy as jnp
    from emotiongestures_torch.ops import audio as PA
    from emotiongestures_tpu.ops import audio as JA

    x = np.random.RandomState(0).randn(3, 50).astype(np.float32)
    for wave in (x, x[0]):
        np.testing.assert_allclose(
            PA.pre_emphasis(torch.from_numpy(wave)).numpy(),
            np.asarray(JA.pre_emphasis(jnp.asarray(wave))), rtol=1e-6,
            atol=1e-7)
    logits, targets = x[:, :8], np.array([0, 3, 7])
    assert PA.topk_accuracy(logits, targets, (1, 3, 5)) == \
        JA.topk_accuracy(logits, targets, (1, 3, 5))


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _datasets(path, remove_word_timing=False, lang=True):
    pairs = []
    for mod, vocab in ((PD, PV), (JD, JV)):
        ds = mod.SpeechMotionDataset(path, use_cache_suffix=False,
                                     remove_word_timing=remove_word_timing)
        if lang:
            v = vocab.Vocab("words")
            for j in range(6):
                v.index_word(f"w{j}")
            ds.set_lang_model(v)
        pairs.append(ds)
    return pairs


def test_eid_helpers_match_jax():
    for i in (0, 64, 65, 72, 94, 111, 118):
        eid = f"1_wayne_0_{i}_{i}"
        np.testing.assert_array_equal(PD.one_hot_eid(eid),
                                      JD.one_hot_eid(eid))
    with pytest.raises(ValueError):
        PD.one_hot_eid("1_wayne_0_119_119")
    assert PD.EMOTION_LABELS == JD.EMOTION_LABELS


@pytest.mark.parametrize("remove_word_timing", [False, True],
                         ids=["timed", "spaced"])
def test_samples_match_jax(tmp_path, remove_word_timing):
    write_window_store(tmp_path / "s", 6, audio_len=lambda i: 63000 + 500 * i)
    p, j = _datasets(tmp_path / "s", remove_word_timing)
    for i in range(len(j)):
        got, want = p[i], j[i]
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                assert got[k].flags.writeable, k  # copied out of the map
            else:
                assert got[k] == want[k], k
    batch = PD.word_seq_collate([p[i] for i in range(4)])
    want = JD.word_seq_collate([j[i] for i in range(4)])
    assert_batches_equal(batch, want)


@pytest.mark.parametrize("native", [True, False], ids=["native", "exact"])
def test_batches_match_jax(tmp_path, native):
    write_window_store(tmp_path / "s", 10)
    p, j = _datasets(tmp_path / "s")
    before = (PD.native_batches, PD.exact_batches)
    got = list(p.batches(4, shuffle=True, seed=2, native=native))
    want = list(j.batches(4, shuffle=True, seed=2, native=native))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert_batches_equal(a, b)
    counted = (PD.native_batches - before[0], PD.exact_batches - before[1])
    assert counted == ((2, 0) if native else (0, 2))
    tail = list(p.batches(4, shuffle=False, drop_last=False,
                          fields=("pose_seq", "text"), native=native))
    for a, b in zip(tail, j.batches(4, shuffle=False, drop_last=False,
                                    fields=("pose_seq", "text"),
                                    native=native)):
        assert_batches_equal(a, b)
    assert [len(b["text"]) for b in tail] == [4, 4, 2]
    rows = list(p.batches(4, shuffle=True, seed=1, rows=slice(1, 3)))
    for a, b in zip(rows, j.batches(4, shuffle=True, seed=1,
                                    rows=slice(1, 3))):
        assert_batches_equal(a, b)


def test_batches_without_vocab_match_jax(tmp_path):
    write_window_store(tmp_path / "s", 8)
    p, j = _datasets(tmp_path / "s", lang=False)
    assert_batches_equal(next(p.batches(4, shuffle=False)),
                         next(j.batches(4, shuffle=False)))


@pytest.mark.parametrize("case", ["ragged", "all-deviant", "short-probe"])
def test_fallbacks_match_jax(tmp_path, case):
    """A ragged record mid-store, a batch whose records all deviate the same
    way, and a store whose record 0 rules the gather out: batches come from
    the exact path, as in the JAX package."""
    audio_len = {"ragged": lambda i: 63000 if i == 5 else 64000,
                 "all-deviant": lambda i: 63000 if i >= 4 else 64000,
                 "short-probe": lambda i: 63000}[case]
    write_window_store(tmp_path / "s", 8, audio_len=audio_len)
    p, j = _datasets(tmp_path / "s")
    before = PD.exact_batches
    got = list(p.batches(4, shuffle=False))
    want = list(j.batches(4, shuffle=False))
    for a, b in zip(got, want):
        assert_batches_equal(a, b)
    assert got[1]["audio"].shape == (4, 64000)
    assert PD.exact_batches - before == {"ragged": 1, "all-deviant": 1,
                                         "short-probe": 2}[case]
    assert (p._fast_probe() is None) == (case == "short-probe")


def test_ted_datasets_build_their_cache_and_match_jax(tmp_path):
    """TedSpeechMotionDataset (10-joint, with a mean dir-vec, motion filters
    on) and its expressive configuration (43 joints, filters off) build
    their caches from a clip store through the preprocessor and give the
    JAX package's samples and batches."""
    from emotiongestures_torch.data.expressive_constants import (
        EXPRESSIVE_MEAN_DIR_VEC,
    )

    mean_pose = np.zeros((10, 3))
    mean_pose[1, 1] = -0.5
    mean_vec = np.random.RandomState(1).randn(27) * 0.1
    for expressive in (False, True):
        n_joints = 43 if expressive else 10
        for name in ("p", "j"):
            write_clip_store(tmp_path / f"{name}{n_joints}", 2, seed=4,
                             n_frames=60, n_joints=n_joints)
        if expressive:
            p = PD.TedSpeechMotionDataset.expressive(tmp_path / "p43")
            j = JD.TedSpeechMotionDataset.expressive(tmp_path / "j43")
            np.testing.assert_array_equal(p.mean_dir_vec.ravel(),
                                          EXPRESSIVE_MEAN_DIR_VEC)
        else:
            kw = dict(mean_dir_vec=mean_vec, mean_pose=mean_pose)
            p = PD.TedSpeechMotionDataset(tmp_path / "p10", **kw)
            j = JD.TedSpeechMotionDataset(tmp_path / "j10", **kw)
        assert len(p) == len(j) > 0
        for f in ("data.bin", "index.npy"):
            assert (tmp_path / f"p{n_joints}_cache" / f).read_bytes() == \
                (tmp_path / f"j{n_joints}_cache" / f).read_bytes()
        for i in range(len(j)):
            got, want = p[i], j[i]
            assert got["vec_seq"].shape[-1] == (126 if expressive else 27)
            for k in want:
                if isinstance(want[k], np.ndarray):
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert_batches_equal(next(p.batches(2, shuffle=False)),
                             next(j.batches(2, shuffle=False)))
