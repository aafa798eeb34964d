"""The MLP CVAEs of the model zoo against the JAX package at fp32 on the CPU:
EmotionCVAEv1, EmotionCVAEv2 and HandCVAE (forward, prior sample, weight
tables), one CVAE train step of v1 and of v2 against the JAX step, both
packages refusing v1/v2 on features other than 512 wide, and
train_auxiliary --cvae_version 1|2 through its `main`.

Weights go torch -> JAX through the JAX package's own tables
(cvae_v1_mapping, cvae_v2_mapping, hand_cvae_mapping), held to the JAX
parameter trees; the reparameterisation and prior noise are injected into
both sides. Tolerances: outputs rtol 2e-4, atol 2e-5 of each output's
largest entry (the parity default); the step as
tests/test_torch_port_aux_train.py (losses rtol 1e-4, parameters atol 2.02
lr, Adam moments rtol 1e-3 with atol 1e-3 of the largest entry).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_train_common as C
from test_torch_port_aux_train import check_step, fresh_jit, jax_state
from torch_port_train_common import one_torch_thread  # noqa: F401
from torch_port_zoo_common import assert_tree_matches, rel_close

from emotiongestures_tpu.models import cvae as jcvae_models
from emotiongestures_tpu.train import cvae as jcvae
from emotiongestures_tpu.utils import torch_port as tp
from emotiongestures_torch.cli import train_auxiliary as aux_cli
from emotiongestures_torch.models import cvae as tcvae_models
from emotiongestures_torch.train import cvae as tcvae
from emotiongestures_torch.utils import weights as W

B = 4
MODELS = {
    "v1": ("EmotionCVAEv1", tp.cvae_v1_mapping, W.cvae_v1_table,
           W.cvae_v1_state_from_jax, (60, 512), 8),
    "v2": ("EmotionCVAEv2", tp.cvae_v2_mapping, W.cvae_v2_table,
           W.cvae_v2_state_from_jax, (60, 512), 8),
    "hand": ("HandCVAE", tp.hand_cvae_mapping, W.hand_cvae_table,
             W.hand_cvae_state_from_jax, (90,), 90),
}


def data(name, seed=0):
    _, _, _, _, xshape, ydim = MODELS[name]
    r = np.random.RandomState(seed)
    x = r.randn(B, *xshape).astype(np.float32)
    y = (np.eye(8, dtype=np.float32)[r.randint(0, 8, B)] if ydim == 8
         else r.randn(B, ydim).astype(np.float32))
    return x, y


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """(name, port module, JAX module, JAX variables with its weights)."""
    name = request.param
    cls, mapping, _, _, _, _ = MODELS[name]
    torch.manual_seed(1)
    model = getattr(tcvae_models, cls)(device="cpu")
    jmodel = getattr(jcvae_models, cls)()
    variables = C.jax_variables(model, mapping())
    x, y = data(name)
    assert_tree_matches(variables, dict(jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "sample": jax.random.PRNGKey(1)},
                            jnp.asarray(x), jnp.asarray(y)))))
    return name, model, jmodel, variables


def test_tables_agree_with_jax_package(pair):
    """The port's copy of the table and its state_dict: the JAX table's
    entries, keys and arrays."""
    name, model, _, variables = pair
    _, mapping, table, state_from_jax, _, _ = MODELS[name]
    assert table() == mapping()
    ours = state_from_jax(variables)
    theirs = tp.flax_table_to_torch_state(variables, mapping())
    assert list(ours) == list(theirs)
    assert set(ours) == set(model.state_dict())
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_and_sample_match_jax(pair, mode, monkeypatch):
    """The posterior pass (reconstruction, mu, logvar) and the prior sample,
    the noise injected; train mode with dropout off on both sides."""
    name, model, jmodel, variables = pair
    x, y = data(name, 2)
    r = np.random.RandomState(3)
    eps = r.randn(B, 32).astype(np.float32)
    z = r.randn(B, 32).astype(np.float32)
    monkeypatch.setattr(
        jcvae_models, "_reparameterize",
        lambda rng, mu, logvar: jnp.asarray(eps) * jnp.exp(0.5 * logvar)
        + mu)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(z))
    train = mode == "train"
    if train:
        C.patch_flax_dropout(monkeypatch)
        C.no_dropout(model)
    model.train(train)
    try:
        with torch.no_grad():
            got = model(torch.from_numpy(x), torch.from_numpy(y),
                        noise=torch.from_numpy(eps))
            sample = model.sample(torch.from_numpy(y),
                                  noise=torch.from_numpy(z))
    finally:
        model.eval()
    rngs = {"sample": jax.random.PRNGKey(0)}
    want = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(y),
                        train=train, rngs=rngs)
    for i, (g, w) in enumerate(zip(got, want)):
        rel_close(g.numpy(), w, msg=f"{name} output {i}")
    rel_close(sample.numpy(), jmodel.apply(
        variables, jnp.asarray(y), train=train, method="sample", rngs=rngs))


@pytest.mark.parametrize("version", [1, 2])
def test_cvae_step_matches_jax(version, monkeypatch):
    """One train step (L1 + 0.1 KL) on 512-wide features, the same
    reparameterisation noise on both sides, dropout off."""
    C.patch_flax_dropout(monkeypatch)
    noise = np.random.RandomState(3).randn(B, 32).astype(np.float32)
    monkeypatch.setattr(
        jcvae_models, "_reparameterize",
        lambda rng, mu, logvar: jnp.asarray(noise) * jnp.exp(0.5 * logvar)
        + mu)
    ts = tcvae.create_state(0, version=version, device="cpu")
    C.no_dropout(ts.module)
    name = f"v{version}"
    mapping = MODELS[name][1]()
    cls = getattr(jcvae_models, MODELS[name][0])
    js = jax_state(monkeypatch, cls, C.jax_variables(ts.module, mapping),
                   jcvae.create_state, version=version)
    x, y = data(name, 5)
    js, jm = fresh_jit(jcvae.train_step, ("beta",))(
        js, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0), beta=0.1)
    ts, tm = tcvae.train_step(ts, torch.from_numpy(x), torch.from_numpy(y),
                              0, beta=0.1, noise=torch.from_numpy(noise))
    for k in ("loss", "recon", "kl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    check_step(ts, js, mapping, [2e-4])


@pytest.mark.parametrize("version", [1, 2])
def test_both_packages_refuse_v1_v2_off_512(version, monkeypatch):
    """Their decoders end at 512: on 64-wide features the JAX step fails on
    the L1 shapes, and the port refuses at create_state. (The JAX state
    holds weights of the init's shapes, not an eager init's draws.)"""
    with pytest.raises(ValueError, match="512"):
        tcvae.create_state(0, version=version, feat_dim=64, device="cpu")
    cls = getattr(jcvae_models, MODELS[f"v{version}"][0])
    shapes = jax.eval_shape(lambda: cls().init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((1, 60, 64)), jnp.zeros((1, 8))))
    variables = jax.tree_util.tree_map(
        lambda a: jnp.full(a.shape, 0.01, a.dtype), shapes)
    js = jax_state(monkeypatch, cls, variables, jcvae.create_state,
                   version=version, feat_dim=64)
    x = jnp.zeros((2, 60, 64))
    y = jnp.eye(8)[:2]
    with pytest.raises((TypeError, ValueError)):
        jcvae.train_step(js, x, y, jax.random.PRNGKey(1))


@pytest.mark.parametrize("version", ["1", "2"])
def test_train_auxiliary_cvae_version(version, tmp_path):
    """--model cvae --cvae_version 1|2 on a d_model-512 generator's
    features (one transformer layer, d_inner 64): two steps, finite
    losses, a checkpoint."""
    run_dir = tmp_path / "run"
    try:
        state, summary = aux_cli.main(aux_cli.build_parser().parse_args([
            "--device", "cpu", "--synthetic", "4", "--batch_size", "2",
            "--total_epoch", "1", "--save_every", "1000", "--model", "cvae",
            "--cvae_version", version, "--d_model", "512", "--latent_dim",
            "64", "--gen_layers", "1", "--model_save_path", str(run_dir)]))
        cls = {"1": "EmotionCVAEv1", "2": "EmotionCVAEv2"}[version]
        assert type(state.module).__name__ == cls
        assert state.step == summary["steps"] == 2
        assert all(np.isfinite(v) for v in summary["metrics"].values())
        assert (run_dir / "cvae" / "checkpoint_iteration2.pt").exists()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
