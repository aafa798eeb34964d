"""The port's reader of orbax checkpoints (utils/ocdbt.py, utils/orbax.py)
against tensorstore and orbax on the CPU.

  * OCDBT stores that tensorstore writes directly, with a small
    max_decoded_node_bytes, a small max_inline_value_bytes, a version tree
    of arity 2 and several commits: interior B+tree nodes of several
    heights, version trees of more than one node, inline and indirect
    values, several data files. The port lists tensorstore's keys in order
    and reads its values byte for byte.
  * Checkpoints that the JAX package's `save_checkpoint` writes (OCDBT, and
    orbax's one-directory-per-array layout), the committed fixture the JAX
    package wrote (tests/fixtures/orbax_jax), and the JAX-free fixture
    writer's output (tests/fixtures/make_orbax_fixture.py): `restore`
    equals `ocp.PyTreeCheckpointer().restore` leaf for leaf (keys, types,
    dtypes, shapes, bytes).
  * A byte flipped in a manifest or a node fails its CRC-32C; what the
    reader does not know raises with the field's name.
"""
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from emotiongestures_torch.utils import ocdbt, orbax

ocp = pytest.importorskip("orbax.checkpoint")
ts = pytest.importorskip("tensorstore")

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def _ts_store(path, **config):
    spec = {"driver": "ocdbt", "base": f"file://{path}/"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _write_commits(path, commits=6, per_commit=15, **config):
    """Several transactions of keys whose values run from empty to a few
    hundred bytes; returns tensorstore's view."""
    kv = _ts_store(path, **config)
    r = np.random.default_rng(0)
    for c in range(commits):
        txn = ts.Transaction()
        for i in range(per_commit):
            n = int(r.integers(0, 300)) if i % 4 else i
            kv.with_transaction(txn)[f"arr{c % 3}.k{i:03d}/{c}"] = \
                r.integers(0, 256, n, dtype=np.uint8).tobytes()
        txn.commit_async().result()
    return kv


@pytest.mark.parametrize("compression", ["zstd", "none"])
def test_tensorstore_store_multilevel(tmp_path, compression):
    kv = _write_commits(tmp_path, max_inline_value_bytes=40,
                        max_decoded_node_bytes=256,
                        version_tree_arity_log2=1,
                        compression={"id": "zstd"} if compression == "zstd"
                        else None)
    keys = sorted(kv.list().result())
    store = ocdbt.OcdbtStore(tmp_path)
    assert store.keys() == keys
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k
    assert store.read("no/such/key") is None
    # what the store held to: a B+tree of height >= 2, a version tree of
    # more than one node, inline and indirect values, several data files
    assert store.version.root_height >= 2
    assert len(store._version_nodes) >= 1
    assert len(store.versions()) == store.version.generation
    kinds = {type(v).__name__ for v in store._values.values()}
    assert kinds == {"bytes", "Location"}
    assert len(list((tmp_path / "d").iterdir())) >= 2
    assert store.config.compression == compression


def test_crc_of_every_node_is_checked(tmp_path):
    _write_commits(tmp_path, commits=3, max_decoded_node_bytes=256,
                   max_inline_value_bytes=40)
    store = ocdbt.OcdbtStore(tmp_path)
    root = store.version.root
    for target, where in ((tmp_path / "manifest.ocdbt", 20),
                          (tmp_path / root.file, root.offset + 20)):
        raw = bytearray(target.read_bytes())
        raw[where] ^= 0x01
        saved = target.read_bytes()
        target.write_bytes(bytes(raw))
        with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
            ocdbt.OcdbtStore(tmp_path)
        target.write_bytes(saved)
    ocdbt.OcdbtStore(tmp_path)


def test_numbered_manifest_is_refused(tmp_path):
    _write_commits(tmp_path, commits=1, manifest_kind="numbered")
    with pytest.raises(ocdbt.OcdbtError, match="manifest_kind"):
        ocdbt.OcdbtStore(tmp_path)


def _jax_checkpoint(path, use_ocdbt=True):
    """The JAX package's save_checkpoint on a TrainState with the optax
    chains the trainers use (adam, and a clipped adam: nested lists and
    None for empty states), integer and float leaves, an empty
    batch_stats."""
    import jax.numpy as jnp
    import optax

    from emotiongestures_tpu.core.schedules import adam
    from emotiongestures_tpu.train.state import create_train_state
    from emotiongestures_tpu.utils import checkpoint as jckpt

    r = np.random.default_rng(0)
    params = {"Dense_0": {"kernel": jnp.asarray(r.standard_normal((40, 300)),
                                                jnp.float32),
                          "bias": jnp.zeros(300, jnp.float32)},
              "embed": jnp.asarray(r.integers(0, 9, (7, 3)), jnp.int32)}
    tx = optax.chain(optax.clip_by_global_norm(1.0), adam(1e-3))
    state = create_train_state(type("M", (), {"apply": None})(),
                               {"params": params}, tx)
    if use_ocdbt:
        return jckpt.save_checkpoint(state.replace(step=7), path)
    handler = ocp.PyTreeCheckpointHandler(use_ocdbt=False)
    with ocp.Checkpointer(handler) as c:
        c.save(path / "checkpoint_iteration7", jckpt._state_tree(
            state.replace(step=7)))
    return path / "checkpoint_iteration7"


@pytest.mark.parametrize("use_ocdbt", [True, False])
def test_jax_save_checkpoint_restores_as_orbax(tmp_path, use_ocdbt):
    path = _jax_checkpoint(tmp_path, use_ocdbt)
    assert orbax.latest_step(tmp_path) == 7
    tree, read = orbax.restore_checkpoint(tmp_path)
    assert read == path
    assert_same_tree(tree, ocp.PyTreeCheckpointer().restore(path))
    assert tree["opt_state"][0] is None and tree["batch_stats"] == {}


@pytest.mark.parametrize("model", ["cvae", "fgd"])
def test_committed_jax_fixture_restores_as_orbax(model):
    path = FIXTURES / "orbax_jax" / model / "checkpoint_iteration2"
    assert_same_tree(orbax.restore(path), ocp.PyTreeCheckpointer().restore(
        path.resolve()))


def test_committed_jax_fixture_gives_jaxs_outputs():
    """The port's CVAE v3 and FGD autoencoder loaded from the committed
    checkpoints give the outputs JAX computed from them (outputs.npz),
    within the parity default of each output's largest entry (rtol 2e-4,
    atol 2e-5; chip_smoke.py phase 13b holds the card to the same)."""
    import torch

    from emotiongestures_torch.models.cvae import EmotionCVAEv3
    from emotiongestures_torch.models.fgd_ae import FGDAutoEncoder
    from emotiongestures_torch.utils import weights

    ref = np.load(FIXTURES / "orbax_jax" / "outputs.npz")
    vae = EmotionCVAEv3(feat_dim=32, device="cpu")
    fgd = FGDAutoEncoder(pose_dim=27, latent_dim=32, device="cpu")
    for net, name in ((vae, "cvae"), (fgd, "fgd")):
        weights.load_reference_checkpoint(net, FIXTURES / "orbax_jax" / name,
                                          table=weights.jax_table(name))
    t = lambda k: torch.from_numpy(ref[k])  # noqa: E731
    with torch.no_grad():
        got = {"cvae_prior": vae.sample(t("cvae_y"), noise=t("cvae_z"))}
        _, got["cvae_mu"], got["cvae_logvar"] = vae(
            t("cvae_x"), t("cvae_y"), noise=t("cvae_z"))
        got["fgd_recon"], got["fgd_feat"] = fgd(t("fgd_x"))
    for name, value in got.items():
        want = ref[name]
        scale = np.abs(want).max()
        np.testing.assert_allclose(value.numpy() / scale, want / scale,
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_fixture_writer_restores_as_orbax(tmp_path):
    """write_orbax's output: orbax restores it, tensorstore lists it, and
    the port reads both the same (leaves of several B+tree leaves under an
    interior root, raw-block zstd frames over 128 KiB)."""
    sys.path.insert(0, str(FIXTURES))
    try:
        from make_orbax_fixture import write_orbax
    finally:
        sys.path.pop(0)
    r = np.random.default_rng(2)
    tree = {"step": np.asarray(5),
            "params": {f"layer{i}": {"kernel": r.standard_normal(
                (i + 1, 64)).astype(np.float32)} for i in range(40)},
            "big": r.standard_normal(50000).astype(np.float32),
            "batch_stats": {},
            "opt_state": [None, {"count": np.asarray(5, np.int32),
                                 "mu": {"x": np.ones((2, 2), np.float32)}},
                          None]}
    write_orbax(tmp_path, tree)
    assert_same_tree(orbax.restore(tmp_path),
                     ocp.PyTreeCheckpointer().restore(tmp_path))
    store = ocdbt.OcdbtStore(tmp_path)
    assert store.version.root_height == 1
    assert store.keys() == sorted(_ts_store(tmp_path).list().result())


def _edit_zarray(path, name, **fields):
    f = path / name / ".zarray"
    meta = json.loads(f.read_text())
    meta.update(fields)
    f.write_text(json.dumps(meta))


@pytest.mark.parametrize("field,value,match", [
    ("compressor", {"id": "blosc"}, "compressor"),
    ("filters", [{"id": "delta"}], "filters"),
    ("order", "F", "order"),
    ("zarr_format", 3, "zarr_format"),
])
def test_unknown_zarr_fields_raise(tmp_path, field, value, match):
    path = _jax_checkpoint(tmp_path, use_ocdbt=False)
    _edit_zarray(path, "params.Dense_0.kernel", **{field: value})
    with pytest.raises(orbax.OrbaxFormatError, match=match):
        orbax.restore(path)


def test_unknown_metadata_raises(tmp_path):
    path = _jax_checkpoint(tmp_path, use_ocdbt=False)
    meta_file = path / "_METADATA"
    meta = json.loads(meta_file.read_text())
    meta["use_zarr3"] = True
    meta_file.write_text(json.dumps(meta))
    with pytest.raises(orbax.OrbaxFormatError, match="zarr3"):
        orbax.restore(path)
    meta["use_zarr3"] = False
    entry = meta["tree_metadata"]["('step',)"]
    entry["value_metadata"]["value_type"] = "jax.sharding.Mystery"
    meta_file.write_text(json.dumps(meta))
    with pytest.raises(orbax.OrbaxFormatError, match="value_type"):
        orbax.restore(path)


def test_missing_chunk_reads_the_fill_value(tmp_path):
    path = _jax_checkpoint(tmp_path, use_ocdbt=False)
    (path / "params.Dense_0.bias" / "0").unlink()
    _edit_zarray(path, "params.Dense_0.bias", fill_value=1.5)
    got = orbax.restore(path)["params"]["Dense_0"]["bias"]
    assert got.dtype == np.float32 and (got == 1.5).all()


def test_latest_step_follows_the_jax_regex(tmp_path):
    for name in ("checkpoint_iteration3", "checkpoint_iteration12",
                 "checkpoint_iteration12.orbax-checkpoint-tmp-1",
                 "xcheckpoint_iteration99"):
        (tmp_path / name).mkdir()
    assert orbax.latest_step(tmp_path) == 12
    assert orbax.latest_step(tmp_path / "absent") is None
    shutil.rmtree(tmp_path / "checkpoint_iteration12")
    assert orbax.latest_step(tmp_path) == 3
