"""The port's data-migration path against the JAX package, on the CPU: the
pyarrow-0.14 reader and writer (the writer's bytes with `flatbuffers`
blocked), the pure-Python LMDB reader, the cache and clip converters (store
bytes), `store_batches`, BEAT's L1div, SRGR and BeatAlignerV1, and
`set_pretrained_embedding` in a small generator. The same inputs, from a
numpy seed, go through both packages."""
import pickle
import struct
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_migration_common as C
import torch_port_train_common as T

from emotiongestures_torch.data import arrow014 as PA
from emotiongestures_torch.data import lmdb_reader as PL
from emotiongestures_torch.data import pipeline as PPipe
from emotiongestures_torch.data import store as PS
from emotiongestures_torch.data.synthetic import materialize_store
from emotiongestures_torch.eval import beat as PB
from emotiongestures_torch.eval import metrics as PM
from emotiongestures_torch.models import generator as PG
from emotiongestures_torch.utils import weights as W
from emotiongestures_tpu.data import arrow014 as JA
from emotiongestures_tpu.data import lmdb_reader as JL
from emotiongestures_tpu.data import pipeline as JPipe
from emotiongestures_tpu.data import store as JS
from emotiongestures_tpu.eval import beat as JB
from emotiongestures_tpu.eval import metrics as JM
from emotiongestures_tpu.models import generator as JG

REPO = Path(__file__).resolve().parent.parent
FIXTURES = C.FIXTURES
FIXTURE_FILES = ("beat_window.arrow014", "ted_window.arrow014")


# ---------------------------------------------------------------------------
# pyarrow-0.14: the reader
# ---------------------------------------------------------------------------

class _NullWriter(JA._BatchWriter):
    """The JAX writer with None as a Null-typed union child (one empty
    validity buffer, every slot null), as a pre-1.0 stream carries it: the
    writers refuse None, the readers decode it."""

    def build_sequence(self, items):
        children, type_of, offset_of = {}, [], []
        for v in items:
            if v is None:
                name, kind = "nones", "null"
            else:
                (name, c), = super().build_sequence([v])["children"].items()
                kind, v = c.kind, c.values[0]
            c = children.setdefault(name, JA._ChildWriter(name, kind))
            type_of.append(list(children).index(name))
            offset_of.append(c.append(v))
        return {"children": children, "type_ids": type_of,
                "offsets": offset_of, "length": len(items)}

    def _render_child(self, name, c):
        if c.kind == "null":
            n = len(c.values)
            return ({"name": name, "type": ("null",), "children": []},
                    [(n, n)], [b""])
        return super()._render_child(name, c)

    def _write_type(self, b, type_spec):
        if type_spec[0] == "null":
            b.StartObject(0)
            return 1, b.EndObject()
        return super()._write_type(b, type_spec)


@pytest.mark.parametrize("name", list(C.OBJECTS))
def test_deserialize_matches_jax(name):
    buf = JA.serialize(C.make_object(name))
    C.assert_same(PA.deserialize(buf), JA.deserialize(buf))


@pytest.mark.parametrize("fixture", FIXTURE_FILES)
def test_deserialize_fixture_matches_jax(fixture):
    buf = (FIXTURES / fixture).read_bytes()
    C.assert_same(PA.deserialize(buf), JA.deserialize(buf))


def test_deserialize_none_matches_jax(monkeypatch):
    """None in lists, tuples and dict values: null children decode to
    None in both readers; both writers refuse None."""
    obj = [None, 1, [None, "x", (None, 2.5)], {"k": None, "j": [None]}]
    monkeypatch.setattr(JA, "_BatchWriter", _NullWriter)
    buf = JA.serialize(obj)
    monkeypatch.undo()
    assert PA.deserialize(buf) == JA.deserialize(buf) == obj
    for serialize in (PA.serialize, JA.serialize):
        with pytest.raises(ValueError, match="None not supported"):
            serialize([1, None])


# ---------------------------------------------------------------------------
# pyarrow-0.14: the writer, with flatbuffers blocked
# ---------------------------------------------------------------------------

_WRITE = """
import pickle, sys
sys.modules["flatbuffers"] = None
from emotiongestures_torch.data.arrow014 import serialize
objs = pickle.load(open(sys.argv[1], "rb"))
pickle.dump({k: serialize(o) for k, o in objs.items()},
            open(sys.argv[2], "wb"))
print("flatbuffers" in sys.modules and sys.modules["flatbuffers"] is None)
"""


@pytest.fixture(scope="module")
def port_bytes(tmp_path_factory):
    """{name: the port's serialize(obj)} from a process in which
    `flatbuffers` cannot be imported, for every object and for the
    committed fixtures' objects."""
    sys.path.insert(0, str(FIXTURES))
    try:
        import make_arrow014_fixtures as mk
    finally:
        sys.path.pop(0)
    objs = {name: C.make_object(name) for name in C.OBJECTS}
    objs.update({"beat_window.arrow014": mk.beat_window(),
                 "ted_window.arrow014": mk.ted_window()})
    tmp = tmp_path_factory.mktemp("arrow014")
    pickle.dump(objs, open(tmp / "objs.pkl", "wb"))
    # the objects as the subprocess sees them (pickling can change an empty
    # array's strides, which the tensor message carries)
    objs = pickle.load(open(tmp / "objs.pkl", "rb"))
    out = subprocess.run(
        [sys.executable, "-c", _WRITE, str(tmp / "objs.pkl"),
         str(tmp / "bytes.pkl")], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"
    return objs, pickle.load(open(tmp / "bytes.pkl", "rb"))


@pytest.mark.parametrize("name", list(C.OBJECTS))
def test_serialize_bytes_match_jax(port_bytes, name):
    objs, got = port_bytes
    assert got[name] == JA.serialize(objs[name])


@pytest.mark.parametrize("fixture", FIXTURE_FILES)
def test_serialize_reproduces_fixture_bytes(port_bytes, fixture):
    objs, got = port_bytes
    assert got[fixture] == (FIXTURES / fixture).read_bytes()
    assert got[fixture] == JA.serialize(objs[fixture])


def test_builder_matches_flatbuffers():
    """The port's builder against the flatbuffers package's Builder on the
    same calls: tables whose layouts match share one vtable, a slot at its
    default is left out, a string and a vector of offsets."""
    import flatbuffers

    fb, b = flatbuffers.Builder(16), PA._Builder(16)
    name, name_fb = b.create_string("ab"), fb.CreateString("ab")
    offs, offs_fb = [], []
    for x in (3, 7, 0):
        b.start_object(2)
        b.add(0, "i", x, 0)
        b.add(1, "h", -2, 0)
        offs.append(b.end_object())
        fb.StartObject(2)
        fb.PrependInt32Slot(0, x, 0)
        fb.PrependInt16Slot(1, -2, 0)
        offs_fb.append(fb.EndObject())
    assert len(b.vtables) == 2  # 3 and 7 share one
    b.start_vector(4, 3, 4)
    fb.StartVector(4, 3, 4)
    for o, o_fb in zip(reversed(offs), reversed(offs_fb)):
        b.prepend_uoffset(o)
        fb.PrependUOffsetTRelative(o_fb)
    vec, vec_fb = b.end_vector(), fb.EndVector()
    b.start_object(2)
    b.add_uoffset(0, name)
    b.add_uoffset(1, vec)
    fb.StartObject(2)
    fb.PrependUOffsetTRelativeSlot(0, name_fb, 0)
    fb.PrependUOffsetTRelativeSlot(1, vec_fb, 0)
    fb.Finish(fb.EndObject())
    assert b.finish(b.end_object()) == bytes(fb.Output())


# ---------------------------------------------------------------------------
# LMDB
# ---------------------------------------------------------------------------

def _lmdb(tmp_path, case):
    rng = np.random.RandomState(1234)
    if case == "committed":
        return FIXTURES / "beat_cache_lmdb"
    if case == "inline_and_overflow":  # tests/test_lmdb_reader.py's
        items = {f"k{i:04d}".encode(): bytes(rng.bytes(8 + i * 13))
                 for i in range(40)}
        items[b"big0"] = bytes(rng.bytes(100_000))
        items[b"big1"] = bytes(rng.bytes(5000))
    else:  # a branch root over several leaves
        items = {f"{i:010d}".encode(): bytes(rng.bytes(120))
                 for i in range(200)}
    return C.write_lmdb(tmp_path / case, items)


@pytest.mark.parametrize("case", ["committed", "inline_and_overflow",
                                  "branch_root"])
def test_lmdb_reader_matches_jax(tmp_path, case):
    path = _lmdb(tmp_path, case)
    got = list(PL.iter_entries(path))
    assert got == list(JL.iter_entries(path)) and got
    assert [k for k, _ in got] == sorted(k for k, _ in got)
    with PL.LmdbEnv(path) as p, JL.LmdbEnv(path) as j:
        assert (len(p), p.depth, p.psize, p.root) == \
            (len(j), j.depth, j.psize, j.root)
        if case == "branch_root":
            assert p.depth == 2
        for key, value in got[::7]:
            assert p.get(key) == j.get(key) == value
        assert p.get(b"missing") is None


@pytest.mark.parametrize("scope", ["dupsort", "leaf2"])
def test_lmdb_reader_scope_matches_jax(tmp_path, scope):
    """Outside the scope both readers raise: DUPSORT on the main database
    (meta page 1's flags), a LEAF2 page (the leaf's flags)."""
    path = C.write_lmdb(tmp_path / "env", {b"a": b"1", b"b": b"2"})
    raw = bytearray((path / "data.mdb").read_bytes())
    if scope == "dupsort":  # dbs[1].md_flags in meta page 1
        at = 4096 + 16 + 24 + 48 + 4
        struct.pack_into("<H", raw, at, 0x04)
    else:  # page 2's flags: P_LEAF | P_LEAF2
        struct.pack_into("<H", raw, 2 * 4096 + 10, 0x02 | 0x20)
    (path / "data.mdb").write_bytes(bytes(raw))
    for reader in (PL, JL):
        with pytest.raises(ValueError, match=scope.upper()):
            list(reader.iter_entries(path))


# ---------------------------------------------------------------------------
# the converters: the same LMDB, the same store bytes
# ---------------------------------------------------------------------------

def _store_bytes(path):
    return [(Path(path) / f).read_bytes() for f in ("data.bin", "index.npy")]


@pytest.mark.parametrize("kind", ["beat", "ted", "committed", "clips"])
def test_converters_write_jax_store_bytes(tmp_path, kind):
    if kind == "committed":
        src = FIXTURES / "beat_cache_lmdb"
    else:
        src = C.write_cache_lmdb(tmp_path / "lmdb", PA.serialize, kind,
                                 n=3 if kind == "clips" else 5)
    port, jax_ = ((PS.convert_clip_lmdb, JS.convert_clip_lmdb)
                  if kind == "clips" else
                  (PS.convert_lmdb_cache, JS.convert_lmdb_cache))
    port(src, tmp_path / "port")
    jax_(src, tmp_path / "jax")
    assert _store_bytes(tmp_path / "port") == _store_bytes(tmp_path / "jax")
    store = PS.GestureStore(tmp_path / "port")
    values = [PA.deserialize(v) for _, v in PL.iter_entries(src)]
    if kind == "clips":
        want = [c for v in values for c in v["clips"]]
        assert len(store) == len(want) == 4
        for i, clip in enumerate(want):
            rec = store[i]
            for k in ("skeletons_3d", "audio_feat", "audio_raw"):
                np.testing.assert_array_equal(rec[k], clip[k])
            assert rec["words"] == clip["words"]
    else:
        assert len(store) == len(values)
        for i, v in enumerate(values):
            rec = store[i]
            np.testing.assert_array_equal(rec["pose_seq"], v[1])
            np.testing.assert_array_equal(rec["spectrogram"], v[-2])
            assert rec["aux_info"] == v[-1]
            assert ("vec_seq" in rec) == (len(v) == 6)
    store.close()


def test_window_record_matches_jax():
    """Both layouts, record for record; a 4-tuple is refused by both."""
    for name in ("beat_window", "ted_window"):
        buf = PA.serialize(C.make_object(name))
        C.assert_same(PS.window_record_from_serialized(buf),
                      JS.window_record_from_serialized(buf))
    buf = PA.serialize([1, 2, 3, 4])
    for fn in (PS.window_record_from_serialized,
               JS.window_record_from_serialized):
        with pytest.raises(ValueError, match="4 fields"):
            fn(buf)


def test_iter_lmdb_takes_the_pure_reader_without_lmdb(tmp_path,
                                                       monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)
    path = _lmdb(tmp_path, "inline_and_overflow")
    assert list(PS._iter_lmdb(path)) == list(JL.iter_entries(path))


# ---------------------------------------------------------------------------
# store_batches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_store(tmp_path_factory):
    path = tmp_path_factory.mktemp("batches") / "s_cache"
    materialize_store(path, 10, seed=2)
    return path


def _eid_label(record):
    return np.eye(8, dtype=np.float32)[len(record["word_seq"]) % 8]


@pytest.mark.parametrize("shuffle,labels", [(True, False), (False, False),
                                            (True, True)],
                         ids=["shuffle", "in-order", "labels"])
def test_store_batches_match_jax(small_store, shuffle, labels):
    fields = ("pose_seq", "spectrogram", "audio")
    kw = dict(labels_fn=_eid_label if labels else None, shuffle=shuffle,
              seed=3)
    port, jstore = PS.GestureStore(small_store), JS.GestureStore(small_store)
    got = list(PPipe.store_batches(port, fields, 4, **kw))
    want = list(JPipe.store_batches(jstore, fields, 4, **kw))
    assert len(got) == len(want) == 2  # the partial batch is dropped
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    port.close()
    jstore.close()


# ---------------------------------------------------------------------------
# BEAT's metrics
# ---------------------------------------------------------------------------

def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def test_l1div_and_srgr_match_jax():
    r = np.random.RandomState(6)
    l1 = (PM.L1div(), JM.L1div())
    srgr = (PM.SRGR(), JM.SRGR())  # 47 joints, threshold 0.1
    for _ in range(3):
        results = r.randn(40, 141)
        targets = results + 0.05 * r.randn(40, 141)
        semantic = (r.rand(40) > 0.5).astype(np.float64)
        for m in l1:
            m.run(results)
        rates = [m.run(results, targets, semantic) for m in srgr]
        assert _rel(*rates) <= 1e-12 and rates[1] > 0
    assert _rel(l1[0].avg(), l1[1].avg()) <= 1e-12
    assert _rel(srgr[0].avg(), srgr[1].avg()) <= 1e-12
    assert srgr[0].pose_dims == 47 and srgr[0].counter == 120


def _speech(r, n_clips=3, seconds=4):
    ts = np.arange(seconds * 16000) / 16000
    envelope = np.clip(np.sin(2 * np.pi * 4.0 * ts), 0, None) ** 2
    return np.stack([r.randn(len(ts)) * (0.05 + envelope)
                     for _ in range(n_clips)]).astype(np.float32)


def test_beat_aligner_v1_matches_jax():
    """The host frontend, three 4 s clips: the batch score, and each clip's
    6 limb beats and right-wrist score, within 1e-12 relative."""
    r = np.random.RandomState(7)
    audio = _speech(r)
    t = np.arange(60)[None, :, None] / 15.0
    poses = np.sin(2 * np.pi * r.uniform(0.5, 3.0, (3, 1, 282)) * t
                   + r.uniform(0, 6, (3, 1, 282)))
    port, ref = PB.BeatAlignerV1(), JB.BeatAlignerV1()
    got, want = port.score_batch(audio, poses), ref.score_batch(audio, poses)
    assert _rel(got, want) <= 1e-12 and want > 0
    for i in range(3):
        beats = port.load_pose(poses[i], 0, 4)
        assert len(beats) == 6
        for a, b in zip(beats, ref.load_pose(poses[i], 0, 4)):
            np.testing.assert_array_equal(a, b)
        onsets = port.load_audio(audio[i])
        clip = port.calculate_align(*onsets, beats)
        assert _rel(clip, ref.calculate_align(*ref.load_audio(audio[i]),
                                              beats)) <= 1e-12


# ---------------------------------------------------------------------------
# set_pretrained_embedding
# ---------------------------------------------------------------------------

def test_set_pretrained_embedding_matches_jax():
    """d_model 64, one layer: the JAX generator with JAX's
    set_pretrained_embedding, and a port generator carrying the same
    weights (generator_state_from_jax) with the port's: the embedding rows
    equal the matrix, and the forward agrees at
    tests/test_torch_port_slice.py's tolerance. The JAX weights are a
    seeded port generator's (flax's init is slow on the CPU)."""
    n_words, B = 40, 2
    small = dict(n_words=n_words, d_model=64, d_inner=128, n_layers=1,
                 n_head=2, d_k=32, d_v=32)
    r = np.random.RandomState(8)
    vectors = r.randn(n_words, 300).astype(np.float32)
    spec = r.randn(B, 128, 124).astype(np.float32)
    text = r.randint(0, n_words, (B, 60))
    prior = r.randn(B, 10, 282).astype(np.float32)

    torch.manual_seed(0)
    seed_gen = PG.GestureTransformer(**small, device="cpu")
    variables = T.jax_variables(seed_gen, T.generator_table(seed_gen))
    variables["params"] = JG.set_pretrained_embedding(variables["params"],
                                                      vectors)
    jgen = JG.GestureTransformer(**small)
    ref = jax.jit(lambda v, *x: jgen.apply(v, *x, train=False))(
        variables, jnp.asarray(spec), jnp.asarray(text), jnp.asarray(prior))

    gen = PG.GestureTransformer(**small, device="cpu")
    state = W.generator_state_from_jax(
        jax.tree_util.tree_map(np.asarray, variables), n_layers=1)
    state["text_encoder.embedding.weight"] = torch.zeros(n_words, 300)
    gen.load_state_dict(state, strict=True)
    weight = gen.text_encoder.embedding.weight
    assert PG.set_pretrained_embedding(gen, vectors) is gen
    assert gen.text_encoder.embedding.weight is weight
    np.testing.assert_array_equal(weight.detach().numpy(), vectors)
    assert weight.dtype == torch.float32
    with torch.no_grad():
        got = gen(torch.from_numpy(spec), torch.from_numpy(text),
                  torch.from_numpy(prior))
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=5e-4)
