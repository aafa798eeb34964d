"""The serving slice as a whole against the JAX package, on the CPU:
wave -> log-mel -> EmotionCVAEv3.sample (injected z) -> GestureTransformer.

The JAX side is the demo/bench recipe: the Pallas mel kernel in interpret
mode, power_to_db per clip, the CVAE's decode from the same z, and the
generator (its fused attention runs the Pallas interpreter off the TPU).
The port side goes through its serving entry point, GestureServer, with the
JAX weights loaded (strict=True).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emotiongestures_tpu.core.precision import bf16_variables, cast_tree
from emotiongestures_tpu.models.cvae import EmotionCVAEv3 as JaxCVAE
from emotiongestures_tpu.models.generator import GestureTransformer as JaxGen
from emotiongestures_tpu.ops.mel import power_to_db
from emotiongestures_tpu.ops.pallas_mel import (
    batched_melspectrogram_pallas,
    extract_melspectrogram_pallas,
)
from emotiongestures_torch.cli import demo
from emotiongestures_torch.serving import GestureServer, set_fused_attention
from emotiongestures_torch.utils import weights as W

SMALL = dict(n_words=24, d_model=64, d_inner=128, n_layers=2, n_head=2,
             d_k=32)
B = 3


def _perturb_stats(variables, seed):
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


def _jax_sample(vae, vvars, y, z):
    post_y = vae.apply(vvars, y, method=lambda m, y: m.y_embed(y, train=False))
    return vae.apply(vvars, z, post_y, z.shape[0], False,
                     method=JaxCVAE._fuse_decode)


@pytest.fixture(scope="module")
def slice_setup():
    r = np.random.RandomState(0)
    waves = (r.randn(B, 64000) * np.array([[0.5], [0.1], [1.0]])
             ).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[[1, 2, 6]]
    text = r.randint(0, SMALL["n_words"], (B, 60))
    prior = r.randn(B, 10, 282).astype(np.float32)
    z = r.randn(B, 32).astype(np.float32)

    jgen_kw = dict(SMALL, d_v=SMALL["d_k"])
    gen = JaxGen(**jgen_kw)
    gvars = _perturb_stats(gen.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 124)),
        jnp.zeros((1, 60), jnp.int32), jnp.zeros((1, 10, 282))), 1)
    vae = JaxCVAE(feat_dim=SMALL["d_model"])
    vvars = _perturb_stats(vae.init(
        {"params": jax.random.PRNGKey(1), "sample": jax.random.PRNGKey(2)},
        jnp.zeros((1, 60, SMALL["d_model"])), jnp.zeros((1, 8))), 2)
    spec_j = jax.vmap(power_to_db)(batched_melspectrogram_pallas(
        jnp.asarray(waves), interpret=True))[..., :124]

    gstate = W.generator_state_from_jax(gvars, n_layers=SMALL["n_layers"])
    vstate = W.cvae_v3_state_from_jax(vvars)
    return dict(waves=waves, y=y, text=text, prior=prior, z=z,
                jgen_kw=jgen_kw, gvars=gvars, vvars=vvars, spec_j=spec_j,
                gstate=gstate, vstate=vstate)


def _server(s, precision, fused):
    server = GestureServer(**SMALL, fused_attention=fused,
                           precision=precision, device="cpu")
    server.gen.load_state_dict(s["gstate"], strict=True)
    server.vae.load_state_dict(s["vstate"], strict=True)
    return server


def _run_port(server, s):
    return server.generate(torch.from_numpy(s["waves"]),
                           torch.from_numpy(s["y"]),
                           torch.from_numpy(s["text"]),
                           torch.from_numpy(s["prior"]),
                           noise=torch.from_numpy(s["z"]))


def _run_jax(s, fused, dtype):
    gen = JaxGen(**s["jgen_kw"], fused_attention=fused)
    vae = JaxCVAE(feat_dim=SMALL["d_model"])
    gvars = jax.tree_util.tree_map(jnp.asarray, s["gvars"])
    vvars = jax.tree_util.tree_map(jnp.asarray, s["vvars"])
    spec, prior = s["spec_j"], jnp.asarray(s["prior"])
    y = jnp.asarray(s["y"])
    if dtype == jnp.bfloat16:
        gvars = bf16_variables(gvars)
        vvars = cast_tree(vvars, jnp.bfloat16)
        spec, prior, y = (a.astype(jnp.bfloat16) for a in (spec, prior, y))
    sampled = _jax_sample(vae, vvars, y, jnp.asarray(s["z"]))
    return gen.apply(gvars, spec, jnp.asarray(s["text"]), prior, sampled,
                     train=False)


@pytest.mark.parametrize("fused", [False, True], ids=["einsum", "fused"])
def test_slice_fp32_matches_jax(slice_setup, fused):
    s = slice_setup
    server = _server(s, "float32", fused)
    spec = server.spectrogram(torch.from_numpy(s["waves"]))
    np.testing.assert_allclose(spec.numpy(), np.asarray(s["spec_j"]),
                               atol=2e-3)
    got = _run_port(server, s)
    ref = _run_jax(s, fused, jnp.float32)
    poses, ref_poses = got[0].numpy(), np.asarray(ref[0])
    assert poses.shape == (B, 60, 282)
    np.testing.assert_allclose(poses, ref_poses, rtol=2e-3, atol=5e-4)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-3,
                                   atol=5e-4)


def test_slice_fused_and_einsum_paths_agree(slice_setup):
    """Same weights, same noise: the fused sublayer only reroutes."""
    s = slice_setup
    server = _server(s, "float32", True)
    fused = _run_port(server, s)[0]
    set_fused_attention(server.gen, False)
    plain = _run_port(server, s)[0]
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_slice_bf16_matches_jax(slice_setup):
    """bf16 serving: the dtypes JAX produces, and values within bf16's
    rounding. bf16 keeps 8 significant bits (relative step 2^-8 ~ 3.9e-3),
    and XLA and PyTorch round at different places (PyTorch's addmm adds
    the bias before rounding, XLA after; reductions differ), so a few
    roundings' worth of drift through ~20 bf16 layers is expected: poses
    are held to 1% of their largest magnitude, the bf16 features to 3%
    (measured here: 0.14% and at most 1.4%)."""
    s = slice_setup
    server = _server(s, "bfloat16", True)
    got = _run_port(server, s)
    ref = _run_jax(s, True, jnp.bfloat16)
    names = ("poses", "emotion", "semantic", "logits", "text")
    expect = ("float32", "bfloat16", "bfloat16", "bfloat16", "bfloat16")
    for name, g, r, dt in zip(names, got, ref, expect):
        assert str(r.dtype) == dt, (name, r.dtype)
        assert str(g.dtype).replace("torch.", "") == dt, (name, g.dtype)
        g32, r32 = g.float().numpy(), np.asarray(r, np.float32)
        frac = 0.01 if name == "poses" else 0.03
        bound = frac * np.abs(r32).max()
        assert np.abs(g32 - r32).max() <= bound, (
            name, np.abs(g32 - r32).max(), bound)


def test_demo_samples_match_jax_recipe(tmp_path):
    """The demo's diverse samples: each is its own batch-one forward
    (TMMemory couples a batch), at the demo's flagship widths, from the same
    injected z, against the JAX demo's recipe (cli/demo.py: Pallas mel ->
    power_to_db -> fp16, then per-key batch-one CVAE sample + generator)."""
    n_samples = 3
    args = demo.build_parser().parse_args([
        "--device", "cpu", "--frontend", "pallas", "--num_samples",
        str(n_samples), "--out", str(tmp_path / "out"),
        "--checkpoints_folder_path", str(tmp_path / "gen.pt"),
        "--cvae_checkpoint", str(tmp_path / "vae.pt")])
    gen, vae = JaxGen(n_words=args.n_words), JaxCVAE()
    wave = demo.load_wave(args)
    spec = jnp.asarray(extract_melspectrogram_pallas(wave, interpret=True),
                       jnp.float32)[None, :, :124]
    text = jnp.zeros((1, 60), jnp.int32)
    prior = jnp.zeros((1, 10, 282), jnp.float32)
    gvars = _perturb_stats(gen.init(jax.random.PRNGKey(0), spec, text,
                                    prior), 3)
    vvars = _perturb_stats(vae.init(
        {"params": jax.random.PRNGKey(1), "sample": jax.random.PRNGKey(2)},
        jnp.zeros((1, 60, 512)), jnp.zeros((1, 8))), 4)
    torch.save(W.generator_state_from_jax(gvars), tmp_path / "gen.pt")
    torch.save(W.cvae_v3_state_from_jax(vvars), tmp_path / "vae.pt")

    z = np.random.RandomState(5).randn(n_samples, 32).astype(np.float32)
    y = jax.nn.one_hot(jnp.asarray([1]), 8)  # happiness
    jg = jax.tree_util.tree_map(jnp.asarray, gvars)
    jv = jax.tree_util.tree_map(jnp.asarray, vvars)
    ref = np.stack([np.asarray(gen.apply(
        jg, spec, text, prior, _jax_sample(vae, jv, y, jnp.asarray(z[i:i + 1])),
        train=False)[0][0]) for i in range(n_samples)])

    summary = demo.main(args, noise=z)
    poses = np.load(summary["out"])["poses"]
    assert poses.shape == (n_samples, 60, 282) and poses.dtype == np.float32
    np.testing.assert_allclose(poses, ref, rtol=2e-3, atol=5e-4)
    assert summary["pairwise_sample_distance"] > 0
    json.dumps(summary)
