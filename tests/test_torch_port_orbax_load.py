"""The JAX package's orbax checkpoints, written by its own `save_checkpoint`,
read by the port (utils/orbax.py, no JAX on the reading side) and loaded
through the weight tables: every model the JAX CLIs restore, at a small
width, on the CPU at fp32.

Per model: the JAX TrainState holds the weights of a seeded port module
(BatchNorm statistics moved off their init) as after two optax Adam
updates (params moved, seeded moments, count and step 2), so params,
batch_stats, step and Adam's moments all differ from any init. The port then
  * loads the model into a module with other weights
    (`load_reference_checkpoint(..., table=jax_table(...))`): its
    state_dict equals the JAX tree through the JAX package's own table, bit
    for bit, and its outputs match the JAX module's on the same inputs at
    the parity default (rtol 2e-4, atol 2e-5 of each output's largest
    entry), the CVAEs' noise injected into both;
  * resumes a train state (`load_checkpoint(..., table=...)`): the step,
    Adam's exp_avg / exp_avg_sq equal to optax's mu / nu bit for bit, its
    step equal to optax's count; and one more update on the same gradients
    gives JAX's next parameters (the FGD autoencoder);
  * keeps a fresh optimizer, with a warning, when the opt_state is not
    Adam's (an SGD state), as the JAX package's load_checkpoint does.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_train_common as C
import test_torch_port_zoo_generator as Z
from torch_port_train_common import one_torch_thread  # noqa: F401
from torch_port_zoo_common import perturb_bn, rel_close

from emotiongestures_tpu.core import schedules as jsched
from emotiongestures_tpu.models import cvae as jcvae
from emotiongestures_tpu.models.discriminator import (
    MotionDiscriminator as JMotionD,
)
from emotiongestures_tpu.models.emotion_net import EmotionNet as JEmotionNet
from emotiongestures_tpu.models.fgd_ae import FGDAutoEncoder as JFGD
from emotiongestures_tpu.models.generator import GestureTransformer as JGen
from emotiongestures_tpu.models.skeleton_classifier import (
    SkeletonTransformer as JSkeleton,
)
from emotiongestures_tpu.train.state import create_train_state
from emotiongestures_tpu.utils import torch_port as tp
from emotiongestures_tpu.utils.checkpoint import save_checkpoint as jax_save
from emotiongestures_torch.core import schedules as tsched
from emotiongestures_torch.models import cvae as tcvae
from emotiongestures_torch.models import generator as G
from emotiongestures_torch.models.discriminator import MotionDiscriminator
from emotiongestures_torch.models.emotion_net import EmotionNet
from emotiongestures_torch.models.fgd_ae import FGDAutoEncoder
from emotiongestures_torch.models.skeleton_classifier import (
    SkeletonTransformer,
)
from emotiongestures_torch.train.state import TrainState
from emotiongestures_torch.utils import weights as W
from emotiongestures_torch.utils.checkpoint import load_checkpoint

B = 3
SKELETON = dict(pose_dim=24, d_model=64, d_inner=128, n_layers=1, n_head=2,
                d_k=32, d_v=32)
CVAE = {"cvae": ("EmotionCVAEv3", tp.cvae_v3_mapping, dict(feat_dim=64), 64),
        "cvae_v1": ("EmotionCVAEv1", tp.cvae_v1_mapping, {}, 512),
        "cvae_v2": ("EmotionCVAEv2", tp.cvae_v2_mapping, {}, 512)}


def _rng(seed):
    return np.random.RandomState(seed)


def _generator(variant):
    def port(seed):
        torch.manual_seed(seed)
        return perturb_bn(G.GestureTransformer(
            **Z.SMALL, spec_len=Z.SPEC_LEN, variant=variant, device="cpu"),
            seed)

    def jax_table(gen):
        return (C.generator_table(gen) if variant == "memory"
                else Z.jax_generator_table(gen, variant))

    def run(module, jmodel, variables, monkeypatch):
        spec, text, prior = Z.inputs(1)
        want = jax.jit(lambda v, *a: jmodel.apply(v, *a))(
            variables, jnp.asarray(spec), jnp.asarray(text),
            jnp.asarray(prior))
        with torch.no_grad():
            got = module(torch.from_numpy(spec), torch.from_numpy(text),
                         torch.from_numpy(prior))
        return list(zip(got, want))

    return (port, lambda: JGen(**Z.SMALL, variant=variant), jax_table,
            W.jax_table("generator", n_layers=1, variant=variant), run)


def _cvae(name):
    cls, mapping, kw, feat = CVAE[name]

    def port(seed):
        torch.manual_seed(seed)
        return perturb_bn(getattr(tcvae, cls)(**kw, device="cpu"), seed)

    def run(module, jmodel, variables, monkeypatch):
        r = _rng(4)
        x = r.randn(B, 60, feat).astype(np.float32)
        y = np.eye(8, dtype=np.float32)[[1, 4, 6]]
        eps = r.randn(B, 32).astype(np.float32)
        z = r.randn(B, 32).astype(np.float32)
        monkeypatch.setattr(
            jcvae, "_reparameterize",
            lambda rng, mu, logvar: jnp.asarray(eps) * jnp.exp(0.5 * logvar)
            + mu)
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, *a, **k: jnp.asarray(z))
        rngs = {"sample": jax.random.PRNGKey(0)}
        # one fresh jit, traced under the patches above
        want = jax.jit(lambda v, x, y: [*jmodel.apply(v, x, y, rngs=rngs),
                                        jmodel.apply(v, y, method="sample",
                                                     rngs=rngs)])(
            variables, jnp.asarray(x), jnp.asarray(y))
        with torch.no_grad():
            got = list(module(torch.from_numpy(x), torch.from_numpy(y),
                              noise=torch.from_numpy(eps)))
            got.append(module.sample(torch.from_numpy(y),
                                     noise=torch.from_numpy(z)))
        return list(zip(got, want))

    return (port, lambda: getattr(jcvae, cls)(**kw),
            lambda module: mapping(), W.jax_table(name), run)


def _plain(build, jbuild, mapping, table, x_shape):
    """A model of one input whose outputs are compared as they are."""
    def port(seed):
        torch.manual_seed(seed)
        return perturb_bn(build(), seed)

    def run(module, jmodel, variables, monkeypatch):
        x = _rng(5).randn(B, *x_shape).astype(np.float32)
        want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
        with torch.no_grad():
            got = module(torch.from_numpy(x))
        if isinstance(got, torch.Tensor):
            got, want = [got], [want]
        return list(zip(got, want))

    return port, jbuild, lambda module: mapping(), table, run


MODELS = {
    **{f"generator_{v}": _generator(v)
       for v in ("memory", "base", "spatial_memory", "padding_initial")},
    **{name: _cvae(name) for name in CVAE},
    "fgd": _plain(lambda: FGDAutoEncoder(pose_dim=27, latent_dim=32,
                                         device="cpu"),
                  lambda: JFGD(pose_dim=27, latent_dim=32),
                  tp.fgd_ae_mapping, W.jax_table("fgd"), (60, 27)),
    "skeleton": _plain(lambda: SkeletonTransformer(**SKELETON, device="cpu"),
                       lambda: JSkeleton(**SKELETON),
                       lambda: tp.skeleton_classifier_mapping(n_layers=1),
                       W.jax_table("skeleton", n_layers=1), (60, 24)),
    # 16 M parameters at 8 x 8 (the MLP's 4096 x 2048 layer is fixed)
    "emotion_net": _plain(lambda: EmotionNet(spec_shape=(8, 8),
                                             device="cpu"),
                          JEmotionNet, tp.emotion_net_mapping,
                          W.jax_table("emotion_net"), (8, 8)),
    "motion_discriminator": _plain(
        lambda: MotionDiscriminator(frames=59, pose_dim=32, d_model=32,
                                    device="cpu"),
        lambda: JMotionD(frames=59, pose_dim=32, d_model=32),
        C.motion_discriminator_table, W.jax_table("motion_discriminator"),
        (59, 32)),
}


def _grads(params, seed):
    r = _rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(0.1 * r.randn(*p.shape), p.dtype), params)


def _trained(jmodel, variables, seed, moments=True):
    """A JAX TrainState as after two updates of the JAX package's adam
    (optax.chain(add_decayed_weights, scale_by_adam, scale)): params moved,
    seeded moments, count and step 2. Built directly: tracing an update or
    the optimizer's init costs more than the rest of a test. Without
    `moments`, mu and nu stay zero (EmotionNet: its 16 M parameters would
    triple the checkpoint)."""
    import optax

    r = np.random.default_rng(seed)

    # numpy throughout: an eager jnp op compiles anew for each leaf's shape
    def draw(p, scale, positive=False):
        x = scale * r.standard_normal(p.shape, np.float32)
        return (np.abs(x) if positive else x).astype(p.dtype)

    tm = jax.tree_util.tree_map
    params = tm(lambda p: np.asarray(p) + draw(p, 1e-3),
                variables["params"])
    if moments:
        mu = tm(lambda p: draw(p, 1e-2), params)
        nu = tm(lambda p: draw(p, 1e-4, True), params)
    else:
        mu = nu = tm(np.zeros_like, params)
    adam = optax.ScaleByAdamState(count=np.asarray(2, np.int32), mu=mu,
                                  nu=nu)
    tx = jsched.adam(lr=1e-3)
    state = create_train_state(jmodel, {"params": {}}, tx)
    return state.replace(
        step=2, params=params, batch_stats=variables.get("batch_stats", {}),
        opt_state=(optax.EmptyState(), adam, optax.EmptyState()))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """name -> (checkpoint directory, JAX module, JAX state, JAX-side
    table), each model built and saved by the JAX package when a test
    first asks for it (xdist may split this file's tests over workers)."""
    root = tmp_path_factory.mktemp("orbax_load")
    cache = {}

    def get(name):
        if name not in cache:
            port, jbuild, jtable, _, _ = MODELS[name]
            module = port(0)
            table = jtable(module)
            jmodel = jbuild()
            state = _trained(jmodel, C.jax_variables(module, table),
                             len(cache), moments=name != "emotion_net")
            jax_save(state, root / name)
            cache[name] = (root / name, jmodel, state, table)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(MODELS))
def test_orbax_checkpoint_loads_and_matches_jax(name, saved, monkeypatch):
    directory, jmodel, state, table = saved(name)
    port, _, _, port_table, run = MODELS[name]
    module = port(1).eval()
    read = W.load_reference_checkpoint(module, directory, table=port_table)
    assert read == directory / "checkpoint_iteration2"
    want = tp.flax_table_to_torch_state(
        {"params": state.params, "batch_stats": state.batch_stats}, table)
    got = module.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    variables = {"params": state.params}
    if state.batch_stats:
        variables["batch_stats"] = state.batch_stats
    for i, (g, w) in enumerate(run(module, jmodel, variables, monkeypatch)):
        rel_close(g.numpy(), w, msg=f"{name} output {i}")


@pytest.mark.parametrize("name", ["generator_memory", "cvae", "skeleton",
                                  "motion_discriminator"])
def test_resume_carries_step_and_adam_moments(name, saved):
    directory, _, state, table = saved(name)
    port, _, _, port_table, _ = MODELS[name]
    module = port(1)
    ts = TrainState(module, tsched.adam(module.parameters(), lr=1e-3))
    ts, ok = load_checkpoint(ts, directory, table=port_table)
    assert ok and ts.step == 2 == int(state.step)
    mu = C.reference(state, table, "mu")
    nu = C.reference(state, table, "nu")
    for n, p in module.named_parameters():
        st = ts.optimizer.state[p]
        assert float(st["step"]) == 2.0
        np.testing.assert_array_equal(st["exp_avg"].double().numpy(), mu[n])
        np.testing.assert_array_equal(st["exp_avg_sq"].double().numpy(),
                                      nu[n])


def test_resumed_update_follows_jax(saved):
    """One more update after the resume, on the same gradients: the port's
    parameters follow JAX's (the moments and the count carried, so the
    bias correction is the third step's)."""
    directory, _, state, table = saved("fgd")
    port, _, _, port_table, _ = MODELS["fgd"]
    module = port(1)
    ts = TrainState(module, tsched.adam(module.parameters(), lr=1e-3))
    load_checkpoint(ts, directory, table=port_table)
    grads = _grads(state.params, 7)
    nxt = jax.jit(lambda s, g: s.apply_gradients(g))(state, grads)
    tgrads = tp.flax_table_to_torch_state({"params": grads}, [
        e for e in table if e[1][0] == "params"])
    ts.apply_gradients([torch.tensor(np.asarray(tgrads[n]))
                        for n, _ in module.named_parameters()])
    want = C.reference(nxt, table, "buffers")
    for n, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().double().numpy(), want[n],
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    assert ts.step == 3


def test_non_adam_opt_state_keeps_the_fresh_optimizer(tmp_path, caplog):
    """An opt_state that is not optax's Adam: params and step load, the
    optimizer stays fresh, with a warning."""
    import optax

    port, jbuild, jtable, port_table, _ = MODELS["fgd"]
    module = port(0)
    table = jtable(module)
    state = C.train_state(jbuild(), C.jax_variables(module, table),
                          optax.sgd(0.1, momentum=0.9))
    state = jax.jit(lambda s, g: s.apply_gradients(g))(
        state, _grads(state.params, 3))
    jax_save(state, tmp_path)
    fresh = port(1)
    ts = TrainState(fresh, tsched.adam(fresh.parameters()))
    with caplog.at_level(logging.WARNING):
        ts, ok = load_checkpoint(ts, tmp_path, table=port_table)
    assert ok and ts.step == 1
    assert "keeping the fresh optimizer state" in caplog.text
    assert not ts.optimizer.state
    want = C.reference(state, table, "buffers")
    for n, p in fresh.named_parameters():
        np.testing.assert_array_equal(p.detach().double().numpy(), want[n])


def test_orbax_directory_without_a_table_is_refused(saved):
    directory = saved("fgd")[0]
    with pytest.raises(ValueError, match="weight table"):
        W.load_reference_checkpoint(MODELS["fgd"][0](1), directory)
