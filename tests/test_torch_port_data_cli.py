"""The port's four CLIs fed from a GestureStore (no --synthetic), against the
JAX CLIs on the CPU, over stores made by the preprocessor from a clip store:

- the eval CLI: both CLIs on one store and the same reference-layout .pth
  files, the port given JAX's per-batch CVAE z, under the tolerances of
  tests/test_torch_port_eval.py::test_eval_cli_matches_jax_cli; the JAX CLI
  writes vocab_all.pkl and the port reads it;
- the GAN, auxiliary and K-fold trainers: the first batch each CLI hands
  its train step equals the JAX CLI's (each train step and state factory
  is swapped for a recorder, so no network is built);
- the port's GAN trainer takes 2 steps on a store at a small width,
  resumes, and ends at step 4.
"""
import os
import shutil
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emotiongestures_torch.cli import (
    test_emotion_gesture_diversity_iterative as port_eval,
)
from emotiongestures_torch.cli import train_audio_classifier_K_fold as port_kf
from emotiongestures_torch.cli import train_auxiliary as port_aux
from emotiongestures_torch.cli import train_emotion_gesture as port_gan
from emotiongestures_torch.data import dataset as PD
from emotiongestures_torch.data.preprocessing import DataPreprocessor
from emotiongestures_torch.data.vocab import Vocab
from emotiongestures_torch.utils import weights as W
from emotiongestures_torch.utils.checkpoint import latest_step
from emotiongestures_tpu.data.vocab import build_vocab as jax_build_vocab
from emotiongestures_tpu.data.store import GestureStore as JaxStore
from test_torch_port_eval import _perturb
from torch_port_data_common import write_clip_store
from torch_port_train_common import one_torch_thread  # noqa: F401


def _store(root, n_clips, n_joints):
    """`<root>/test_cache`: the 60-frame windows of `n_clips` 10 s clips (4
    each); returns the data path the CLIs take."""
    write_clip_store(root / "clips", n_clips, seed=7, n_joints=n_joints)
    DataPreprocessor(root / "clips", root / "test_cache", n_poses=60,
                     subdivision_stride=30, pose_resampling_fps=15).run()
    shutil.rmtree(root / "clips")
    return root / "test"


@pytest.fixture(scope="module")
def beat_store(tmp_path_factory):
    """16 windows of 60 frames, 94 joints (pose 282)."""
    root = tmp_path_factory.mktemp("beat")
    path = _store(root, 4, 94)
    yield path
    shutil.rmtree(root, ignore_errors=True)


SMALL_EVAL = ["--test_batch_size", "8", "--d_model", "64", "--gen_layers",
              "1", "--latent_dim", "128", "--num_devices", "1",
              "--num_diversity_passes", "2"]


def test_eval_cli_on_a_store_matches_jax_cli(beat_store, tmp_path):
    from emotiongestures_tpu.cli import (
        test_emotion_gesture_diversity_iterative as jax_cli,
    )
    from emotiongestures_tpu.models.cvae import EmotionCVAEv3 as JaxCVAE
    from emotiongestures_tpu.models.fgd_ae import FGDAutoEncoder as JaxFGD
    from emotiongestures_tpu.models.generator import (
        GestureTransformer as JaxGen,
    )
    from emotiongestures_tpu.models.skeleton_classifier import (
        SkeletonTransformer as JaxSkeleton,
    )

    vocab_path = beat_store.parent / "vocab_all.pkl"
    n_words = jax_build_vocab("words", [JaxStore(str(beat_store) + "_cache")],
                              vocab_path).n_words
    seed, batch = 0, 8
    gen = JaxGen(n_words=n_words, d_model=64, d_inner=128, n_layers=1,
                 n_head=8, d_k=64, d_v=64, chunk_length=10, text_dropout=0.1)
    gv = _perturb(gen.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 124)),
                           jnp.zeros((1, 60), jnp.int32),
                           jnp.zeros((1, 10, 282))), 1)
    fv = JaxFGD().init(jax.random.PRNGKey(1), jnp.zeros((1, 60, 282)))
    sv = JaxSkeleton(d_model=512, d_inner=128, n_layers=3).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 60, 282)))
    vae = JaxCVAE(feat_dim=64)
    vv = _perturb(vae.init({"params": jax.random.PRNGKey(3),
                            "sample": jax.random.PRNGKey(4)},
                           jnp.zeros((1, 60, 64)), jnp.zeros((1, 8))), 2)
    paths = {name: tmp_path / f"{name}.pth" for name in
             ("gen", "fgd", "skel", "vae")}
    torch.save({f"module.{k}": v for k, v in
                W.generator_state_from_jax(gv, n_layers=1).items()},
               paths["gen"])
    torch.save(W.fgd_ae_state_from_jax(fv), paths["fgd"])
    torch.save({"gen_dict": W.skeleton_classifier_state_from_jax(sv)},
               paths["skel"])
    torch.save(W.cvae_v3_state_from_jax(vv), paths["vae"])
    flags = SMALL_EVAL + [
        "--test_data_path", str(beat_store),
        "--checkpoints_folder_path", str(paths["gen"]),
        "--fgd_checkpoint", str(paths["fgd"]),
        "--skeleton_checkpoint", str(paths["skel"]),
        "--cvae_checkpoint", str(paths["vae"])]
    jvv = jax.tree_util.tree_map(jnp.asarray, vv)

    def noise(i, k):  # JAX's z of batch i, pass k
        key = jax.random.fold_in(jax.random.PRNGKey(seed + 1), i)
        key = key if k == 0 else jax.random.fold_in(key, 1000 + k - 1)
        return np.asarray(vae.apply(
            jvv, jnp.zeros((batch, 8)),
            method=lambda m, y: jax.random.normal(
                m.make_rng("sample"), (y.shape[0], m.latent_dim)),
            rngs={"sample": key}))

    want = jax_cli.main(jax_cli.build_parser().parse_args(
        flags + ["--log_save_path", str(tmp_path / "jax")]))
    before = (PD.native_batches, PD.exact_batches)
    got = port_eval.main(port_eval.build_parser().parse_args(
        flags + ["--log_save_path", str(tmp_path / "port"),
                 "--device", "cpu"]), noise=noise)
    assert got["timings"]["eval_batch_calls"] == 4
    assert (PD.native_batches - before[0], PD.exact_batches - before[1]) \
        == (2, 0)
    assert Vocab.load(vocab_path).n_words == n_words
    for key in ("l2", "mpjre_deg", "diversity"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(got["fgd"], want["fgd"], rtol=1e-4)
    assert got["emotion_acc"] == want["emotion_acc"]
    assert abs(got["beat"] - want["beat"]) <= 1e-3
    assert want["beat"] > 0


class _Stop(Exception):
    pass


@pytest.fixture
def keep_signals():
    """The JAX GAN trainer enters GracefulShutdown without a `with`: put
    the process's handlers back."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def _first_batch(monkeypatch, module, state_fn, step_fn, main, keys):
    """Run `main` with `module.state_fn` returning a stub state and
    `module.step_fn` recording the arrays at `keys` of its call and
    stopping the run."""
    seen = {}

    def record(*args, **kwargs):
        for k, pos in keys.items():
            seen[k] = np.asarray(args[pos] if isinstance(pos, int)
                                 else args[pos[0]][pos[1]], np.float32)
        raise _Stop

    monkeypatch.setattr(module, state_fn, lambda *a, **k: (
        (types.SimpleNamespace(step=0),) * 2 if state_fn == "create_states"
        else types.SimpleNamespace(step=0)))
    monkeypatch.setattr(module, step_fn, record)
    with pytest.raises(_Stop):
        main()
    monkeypatch.undo()
    return seen


def _compare(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gan_trainer_reads_the_jax_batches(beat_store, tmp_path,
                                           monkeypatch, keep_signals):
    from emotiongestures_torch.train import gan as port_train
    from emotiongestures_tpu.cli import train_emotion_gesture as jax_cli
    from emotiongestures_tpu.train import gan as jax_train

    flags = ["--train_data_path", str(beat_store), "--batch_size", "8",
             "--prefetch", "0", "--num_devices", "1", "--seed", "3"]
    keys = {k: (2, k) for k in port_gan.BATCH_KEYS}
    want = _first_batch(monkeypatch, jax_train, "create_states",
                        "train_step", lambda: jax_cli.main(
                            jax_cli.build_parser().parse_args(flags + [
                                "--model_save_path", str(tmp_path / "j")])),
                        keys)
    got = _first_batch(monkeypatch, port_train, "create_states",
                       "train_step", lambda: port_gan.main(
                           port_gan.build_parser().parse_args(flags + [
                               "--model_save_path", str(tmp_path / "p"),
                               "--device", "cpu"])), keys)
    _compare(got, want)
    assert want["text"].any()  # the store's words reach the text grid


def test_aux_trainer_reads_the_jax_batches(beat_store, tmp_path,
                                           monkeypatch):
    from emotiongestures_torch.train import fgd as port_train
    from emotiongestures_tpu.cli import train_auxiliary as jax_cli
    from emotiongestures_tpu.train import fgd as jax_train

    flags = ["--model", "fgd", "--train_data_path", str(beat_store),
             "--batch_size", "8", "--prefetch", "0", "--num_devices", "1",
             "--seed", "5"]
    want = _first_batch(monkeypatch, jax_train, "create_state", "train_step",
                        lambda: jax_cli.main(jax_cli.build_parser()
                                             .parse_args(flags + [
                                                 "--model_save_path",
                                                 str(tmp_path / "j")])),
                        {"pose_seq": 1})
    got = _first_batch(monkeypatch, port_train, "create_state", "train_step",
                       lambda: port_aux.main(port_aux.build_parser()
                                             .parse_args(flags + [
                                                 "--model_save_path",
                                                 str(tmp_path / "p"),
                                                 "--device", "cpu"])),
                       {"pose_seq": 1})
    _compare(got, want)


def test_kfold_cli_reads_the_jax_batches(beat_store, tmp_path, monkeypatch):
    from emotiongestures_torch.train import classifier as port_train
    from emotiongestures_tpu.cli import (
        train_audio_classifier_K_fold as jax_cli,
    )
    from emotiongestures_tpu.train import classifier as jax_train

    flags = ["--train_data_path", str(beat_store), "--val_data_path",
             str(beat_store), "--test_data_path", str(beat_store),
             "--batch_size", "8", "--prefetch", "0", "--num_devices", "1",
             "--max_folds", "1"]
    keys = {"spectrogram": 1, "eid_label": 2, "alpha": 3}
    want = _first_batch(monkeypatch, jax_train, "create_state", "train_step",
                        lambda: jax_cli.main(jax_cli.build_parser()
                                             .parse_args(flags + [
                                                 "--model_save_path",
                                                 str(tmp_path / "j")])),
                        keys)
    got = _first_batch(monkeypatch, port_train, "create_state", "train_step",
                       lambda: port_kf.main(port_kf.build_parser()
                                            .parse_args(flags + [
                                                "--model_save_path",
                                                str(tmp_path / "p"),
                                                "--device", "cpu"])), keys)
    _compare(got, want)
    assert got["spectrogram"].shape == (8, 128, 124)


def test_gan_trainer_trains_and_resumes_on_a_store(tmp_path):
    """2 steps of batch 2 on a 4-window store (4 joints: pose 12), then
    --resume for one more epoch: steps 2 and 4, finite losses, the
    vocabulary's size in the word embedding."""
    data = _store(tmp_path / "data", 1, 4)
    run = tmp_path / "run"
    flags = port_gan.build_parser().parse_args([
        "--device", "cpu", "--train_data_path", str(data), "--batch_size",
        "2", "--pose_dim", "12",
        "--d_model", "16", "--latent_dim", "32", "--gen_layers", "1",
        "--save_every", "1000", "--total_epoch", "1", "--model_save_path",
        str(run)])
    gen, disc, summary = port_gan.main(flags)
    assert gen.step == disc.step == 2 == latest_step(run / "generator")
    assert all(np.isfinite(v) for v in summary["metrics"].values())
    n_words = gen.module.text_encoder.embedding.num_embeddings
    assert n_words > 4  # the specials and the store's words
    flags.resume = True
    gen, disc, summary = port_gan.main(flags)
    assert gen.step == disc.step == 4 == latest_step(run / "discriminator")
    assert all(np.isfinite(v) for v in summary["metrics"].values())
    shutil.rmtree(run)
    assert not os.path.exists(run)
