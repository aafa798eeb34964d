"""The diversity-eval slice of the port against the JAX package, on the CPU.

Module by module (FGD autoencoder, skeleton classifier, the host metrics,
the beat stack and its batched frontend, the synthetic dataset, the parser)
and as a whole: the JAX eval CLI and the port's, both reading the same
reference-layout .pth files, at a small width, with the port given JAX's
per-batch CVAE z through its test-only noise hook.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emotiongestures_torch.cli import (
    test_emotion_gesture_diversity_iterative as port_cli,
)
from emotiongestures_torch.data.synthetic import SyntheticGestureDataset
from emotiongestures_torch.eval import beat as PB
from emotiongestures_torch.eval import fgd as PF
from emotiongestures_torch.eval import metrics as PM
from emotiongestures_torch.models.fgd_ae import FGDAutoEncoder
from emotiongestures_torch.models.skeleton_classifier import (
    SkeletonTransformer,
)
from emotiongestures_torch.utils import weights as W

TOL = dict(rtol=2e-4, atol=2e-5)


def _speechlike(seed, n=64000):
    """Broadband noise with syllable-rate (4 Hz) bursts, as
    tests/test_golden_audio.py uses for the speech domain."""
    r = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    envelope = np.clip(np.sin(2 * np.pi * 4.0 * t), 0, None) ** 2
    return (r.randn(n) * (0.05 + envelope)).astype(np.float32)


def _perturb(variables, seed):
    """numpy copy of a JAX tree with BatchNorm statistics off their init."""
    r = np.random.RandomState(seed)

    def walk(tree, name=None):
        if hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.array(tree, np.float32)
        if name == "mean":
            a = a + 0.1 * r.randn(*a.shape).astype(np.float32)
        elif name == "var":
            a = a * r.uniform(0.7, 1.3, a.shape).astype(np.float32)
        return a

    return walk(dict(variables))


def test_fgd_autoencoder_matches_jax():
    from emotiongestures_tpu.models.fgd_ae import FGDAutoEncoder as JaxFGD

    x = np.random.RandomState(0).randn(2, 60, 282).astype(np.float32)
    jnet = JaxFGD()
    v = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    recon_j, latent_j = jnet.apply(v, jnp.asarray(x))
    net = FGDAutoEncoder(device="cpu")
    net.load_state_dict(W.fgd_ae_state_from_jax(v), strict=True)
    with torch.no_grad():
        recon, latent = net(torch.from_numpy(x))
    np.testing.assert_allclose(latent.numpy(), np.asarray(latent_j), **TOL)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), **TOL)


def test_skeleton_classifier_matches_jax():
    from emotiongestures_tpu.models.skeleton_classifier import (
        SkeletonTransformer as JaxSkeleton,
    )

    kw = dict(d_model=64, d_inner=128, n_layers=2, n_head=2, d_k=32, d_v=32)
    x = np.random.RandomState(1).randn(3, 60, 282).astype(np.float32)
    jnet = JaxSkeleton(**kw)
    v = _perturb(jnet.init(jax.random.PRNGKey(1), jnp.asarray(x)), 0)
    logits_j, mid_j = jnet.apply(jax.tree_util.tree_map(jnp.asarray, v),
                                 jnp.asarray(x))
    net = SkeletonTransformer(**kw, device="cpu")
    net.load_state_dict(
        W.skeleton_classifier_state_from_jax(v, n_layers=2), strict=True)
    with torch.no_grad():
        logits, mid = net(torch.from_numpy(x))
    assert logits.shape == (3, 8) and mid.shape == (3, 60, 64)
    np.testing.assert_allclose(mid.numpy(), np.asarray(mid_j), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)


def test_fgd_and_metrics_match_jax():
    from emotiongestures_tpu.eval import fgd as JF
    from emotiongestures_tpu.eval import metrics as JM

    r = np.random.RandomState(2)
    pred = r.randn(240, 512)
    target = 0.8 * r.randn(240, 512) + 0.1
    assert PF.frechet_from_features(pred, target) == \
        JF.frechet_from_features(pred, target)
    # rank-deficient covariances: sqrtm's product is singular
    few = r.randn(8, 16)
    assert PF.frechet_from_features(few, few[::-1] * 2) == \
        JF.frechet_from_features(few, few[::-1] * 2)
    assert PF.diversity_score(pred, seed=3) == JF.diversity_score(pred,
                                                                  seed=3)
    fake, gt = r.randn(4, 60, 282), r.randn(4, 60, 282)
    assert PM.l2_distance_pose(fake, gt) == JM.l2_distance_pose(fake, gt)
    assert PM.mpjre(gt, fake) == JM.mpjre(gt, fake)
    logits, labels = r.randn(32, 8), r.randint(0, 8, 32)
    assert PM.compute_acc(labels, logits) == JM.compute_acc(labels, logits)
    ours, theirs = PM.AverageMeter("l2", ":.3f"), JM.AverageMeter("l2",
                                                                  ":.3f")
    for val, n in ((1.5, 2), (0.25, 6)):
        ours.update(val, n)
        theirs.update(val, n)
    assert str(ours) == str(theirs) and ours.avg == theirs.avg


def test_host_beat_stack_matches_jax():
    from emotiongestures_tpu.eval import beat as JB

    waves = np.stack([_speechlike(3), _speechlike(4)]).astype(np.float64)
    poses = np.random.RandomState(5).randn(2, 60, 282).cumsum(axis=1) * 0.01
    for w in waves:
        env = PB.onset_strength(w)
        np.testing.assert_array_equal(env, JB.onset_strength(w))
        np.testing.assert_array_equal(PB.stft_rms(w), JB.stft_rms(w))
        onsets = PB.onset_detect(env)
        np.testing.assert_array_equal(onsets, JB.onset_detect(env))
        np.testing.assert_array_equal(PB.onset_backtrack(onsets, env),
                                      JB.onset_backtrack(onsets, env))
    ours = PB.BeatAligner().score_batch(waves, poses)
    assert ours == JB.BeatAligner().score_batch(waves, poses)
    assert ours > 0


def test_onset_frontend_matches_jax_broadband():
    """The torch frontend against the JAX one (XLA, fp32) on broadband
    waves: the same detected onsets, as tests/test_golden_audio.py requires
    of the JAX frontend against the fp64 host path; envelopes within 1% of
    their peak and RMS within rtol 1e-3 (both fp32, summed in another
    order)."""
    from emotiongestures_tpu.eval import beat as JB

    waves = np.stack([_speechlike(7), _speechlike(8), _speechlike(9)])
    envs, rmss = PB.batched_onset_frontend(waves, device="cpu")
    envs_j, rmss_j = JB.batched_onset_frontend(waves)
    assert envs.shape == envs_j.shape == (3, 126)
    for i in range(3):
        assert np.abs(envs[i] - envs_j[i]).max() < 0.01 * envs_j[i].max()
        np.testing.assert_allclose(rmss[i], rmss_j[i], rtol=1e-3, atol=1e-6)
        np.testing.assert_array_equal(PB.onset_detect(envs[i]),
                                      JB.onset_detect(envs_j[i]))
        np.testing.assert_array_equal(PB.onset_detect(envs[i]),
                                      PB.onset_detect(PB.onset_strength(
                                          waves[i].astype(np.float64))))


@pytest.mark.parametrize("overlap", [0.0, 0.6])
def test_synthetic_dataset_matches_jax(overlap):
    from emotiongestures_tpu.data.synthetic import (
        SyntheticGestureDataset as JaxDataset,
    )

    fields = ("audio", "spectrogram", "pose_seq", "eid_label", "text")
    ours = SyntheticGestureDataset(n_samples=6, seed=3,
                                   class_overlap=overlap)
    theirs = JaxDataset(n_samples=6, seed=3, class_overlap=overlap)
    for shuffle in (False, True):
        got = list(ours.batches(3, shuffle=shuffle, seed=1, fields=fields))
        want = list(theirs.batches(3, shuffle=shuffle, seed=1,
                                   fields=fields))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in fields:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    assert ours[4]["aux_info"] == theirs[4]["aux_info"]


def test_parser_flag_surface_matches_jax():
    """Every flag of the JAX eval CLI, with its default, plus --device."""
    from emotiongestures_tpu.cli.test_emotion_gesture_diversity_iterative \
        import build_parser as jax_parser

    theirs = vars(jax_parser().parse_args([]))
    ours = vars(port_cli.build_parser().parse_args([]))
    assert set(ours) == set(theirs) | {"device"}
    for name, default in theirs.items():
        assert ours[name] == default, name
    assert ours["device"] == "cuda"
    fast = port_cli.build_parser().parse_args(["--preset", "fast"])
    port_cli.apply_preset(fast, port_cli.build_parser(), port_cli.EVAL_FAST)
    assert (fast.precision, fast.fused_attention, fast.device_beat) == \
        ("bfloat16", True, True)
    kept = port_cli.build_parser().parse_args(["--preset", "fast",
                                               "--precision", "float32"])
    port_cli.apply_preset(kept, port_cli.build_parser(), port_cli.EVAL_FAST,
                          argv=["--preset", "fast", "--precision", "float32"])
    assert kept.precision == "float32" and kept.fused_attention


@pytest.mark.parametrize("flags,error,match", [
    ([], FileNotFoundError, "no GestureStore"),
    (["--synthetic", "8", "--num_devices", "2"], NotImplementedError,
     "one card"),
    (["--synthetic", "8", "--model_parallel", "2"], NotImplementedError,
     "one card"),
], ids=["missing-store", "devices", "model-parallel"])
def test_cli_refuses_what_is_not_ported(flags, error, match, tmp_path):
    """Without --synthetic the CLI reads the store at --test_data_path and
    names it when it is missing; more than one card is not ported."""
    args = port_cli.build_parser().parse_args(
        ["--device", "cpu", "--log_save_path", str(tmp_path),
         "--test_data_path", str(tmp_path / "test")] + flags)
    with pytest.raises(error, match=match):
        port_cli.main(args)


def test_checkpoint_flags_refuse_orbax_directories(tmp_path):
    args = port_cli.build_parser().parse_args([
        "--device", "cpu", "--fgd_checkpoint", str(tmp_path),
        "--d_model", "64", "--gen_layers", "1", "--latent_dim", "128"])
    with pytest.raises(ValueError, match="orbax"):
        port_cli.build_models(args, 64, torch.device("cpu"))


SMALL_FLAGS = ["--synthetic", "16", "--test_batch_size", "8", "--d_model",
               "64", "--gen_layers", "1", "--latent_dim", "128",
               "--num_devices", "1", "--num_diversity_passes", "2"]


def test_eval_cli_matches_jax_cli(tmp_path):
    """Both CLIs on the same reference-layout .pth files, fp32, with beat
    alignment; the port gets JAX's per-batch CVAE z (batch i: fold_in(
    PRNGKey(seed + 1), i); extra pass k: fold_in of that key with 1000 + k).
    Tolerances: l2, mpjre, diversity rtol 1e-5 (measured here: 2e-7 at
    most, fp32 sums in another order); FGD rtol 1e-4 (a Fréchet distance
    through sqrtm can amplify feature differences; measured 1.3e-9);
    Emotion-Acc equal (argmax of the same logits); beat atol 1e-3, about
    one limb's beat in one clip (a velocity minimum of a generated pose can
    shift by a frame on an fp32 rounding; measured equal)."""
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

    seed, batch = 0, 8
    gen = JaxGen(n_words=64, d_model=64, d_inner=128, n_layers=1, n_head=8,
                 d_k=64, d_v=64, chunk_length=10, text_dropout=0.1)
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
    ckpt = ["--checkpoints_folder_path", str(paths["gen"]),
            "--fgd_checkpoint", str(paths["fgd"]),
            "--skeleton_checkpoint", str(paths["skel"]),
            "--cvae_checkpoint", str(paths["vae"])]

    jvv = jax.tree_util.tree_map(jnp.asarray, vv)

    def jax_key(i, k):
        key = jax.random.fold_in(jax.random.PRNGKey(seed + 1), i)
        return key if k == 0 else jax.random.fold_in(key, 1000 + k - 1)

    def noise(i, k):
        return np.asarray(vae.apply(
            jvv, jnp.zeros((batch, 8)),
            method=lambda m, y: jax.random.normal(
                m.make_rng("sample"), (y.shape[0], m.latent_dim)),
            rngs={"sample": jax_key(i, k)}))

    # the hook's z is the one JAX's own sample draws
    y = jnp.eye(8)[:batch]
    drawn = vae.apply(jvv, y, method="sample", rngs={"sample": jax_key(0, 0)})
    post_y = vae.apply(jvv, y, method=lambda m, y: m.y_embed(y, train=False))
    redone = vae.apply(jvv, jnp.asarray(noise(0, 0)), post_y, batch, False,
                       method=JaxCVAE._fuse_decode)
    np.testing.assert_allclose(np.asarray(drawn), np.asarray(redone),
                               rtol=1e-6, atol=1e-6)

    want = jax_cli.main(jax_cli.build_parser().parse_args(
        SMALL_FLAGS + ckpt + ["--log_save_path", str(tmp_path / "jax")]))
    got = port_cli.main(port_cli.build_parser().parse_args(
        SMALL_FLAGS + ckpt + ["--log_save_path", str(tmp_path / "port"),
                              "--device", "cpu"]), noise=noise)
    assert got["timings"]["eval_batch_calls"] == 4
    for key in ("l2", "mpjre_deg", "diversity"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(got["fgd"], want["fgd"], rtol=1e-4)
    assert got["emotion_acc"] == want["emotion_acc"]
    assert abs(got["beat"] - want["beat"]) <= 1e-3
    assert want["beat"] > 0
