"""The port's auxiliary trainers (emotiongestures_torch/train/{fgd,skeleton,
cvae}.py) against the JAX package's, at fp32 on the CPU.

Each JAX state is built by the JAX package's own `create_state` with the
model's flax `init` patched to return the port's weights (carried through
the JAX package's tables), so the optimizer chain is the JAX one and no
eager flax init runs. Dropout is off on both sides (the port's p = 0,
flax's Dropout patched to identity); the CVAE's reparameterisation noise is
injected into both.

Tolerances (as tests/test_torch_port_train_*.py):
  * losses rtol 1e-4: the same fp32 formulas over other summation orders;
  * parameters atol 2.02 * (the sum of the steps' learning rates): Adam's
    first updates are about lr * sign(g), and where |g| is near eps any
    difference in g can flip one (1% for the rounding of the weights);
  * Adam moments rtol 1e-3, atol 1e-3 of the tensor's largest entry;
  * running statistics rtol 1e-4, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_train_common as C
from torch_port_train_common import one_torch_thread  # noqa: F401

from emotiongestures_tpu.models import cvae as jcvae_models
from emotiongestures_tpu.models.cvae import EmotionCVAEv3 as JaxCVAE
from emotiongestures_tpu.models.fgd_ae import FGDAutoEncoder as JaxFGD
from emotiongestures_tpu.models.skeleton_classifier import (
    SkeletonTransformer as JaxSkeleton,
)
from emotiongestures_tpu.train import cvae as jcvae
from emotiongestures_tpu.train import fgd as jfgd
from emotiongestures_tpu.train import skeleton as jskeleton
from emotiongestures_tpu.utils import torch_port as tp
from emotiongestures_torch.core.layers import Dropout, dropout_generator
from emotiongestures_torch.models.cvae import EmotionCVAEv3
from emotiongestures_torch.models.fgd_ae import FGDAutoEncoder
from emotiongestures_torch.models.skeleton_classifier import (
    SkeletonTransformer,
)
from emotiongestures_torch.train import cvae as tcvae
from emotiongestures_torch.train import fgd as tfgd
from emotiongestures_torch.train import skeleton as tskeleton
from emotiongestures_torch.train.gan import step_key
from emotiongestures_torch.train.state import clip_by_global_norm

B = 4
# a narrow skeleton classifier: the flatten head is n_position * d_model
SKEL = dict(d_model=32, d_inner=64)
SKEL_LAYERS = 3


def poses(seed=0, b=B, d=282):
    return (0.5 * np.random.RandomState(seed).randn(b, 60, d)).astype(
        np.float32)


def onehot(b=B, seed=0):
    labels = np.random.RandomState(seed + 100).randint(0, 8, b)
    return np.eye(8, dtype=np.float32)[labels]


def jax_state(monkeypatch, model_cls, variables, create, **kw):
    """The JAX package's create_state on the port's weights."""
    monkeypatch.setattr(model_cls, "init", lambda self, *a, **k: variables)
    return create(jax.random.PRNGKey(0), **kw)


def fresh_jit(fn, static=()):
    """A jitted function's body under a new jit: a trace made while flax's
    Dropout (or the CVAE's noise) is patched, never a cached one."""
    return jax.jit(fn.__wrapped__, static_argnames=static)


def check_step(tstate, jstate, table, lrs, buffers=False):
    snap = C.snapshot(tstate)
    C.assert_close(snap, jstate, table, "params",
                   lambda name: (0.0, 2.02 * sum(lrs)))
    for what in ("mu", "nu"):
        C.assert_close(snap, jstate, table, what,
                       lambda name: (1e-3, lambda scale: 1e-3 * scale))
    if buffers:
        C.assert_close(snap, jstate, table, "buffers",
                       lambda name: (1e-4, 1e-6))
    C.assert_counts(snap, jstate, len(lrs))
    return snap


def test_fgd_one_step(monkeypatch):
    C.patch_flax_dropout(monkeypatch)
    ts = tfgd.create_state(0, device="cpu")
    C.no_dropout(ts.module)
    table = tp.fgd_ae_mapping()
    js = jax_state(monkeypatch, JaxFGD, C.jax_variables(ts.module, table),
                   jfgd.create_state)
    x = poses()
    js, jm = fresh_jit(jfgd.train_step)(js, jnp.asarray(x),
                                        jax.random.PRNGKey(0))
    ts, tm = tfgd.train_step(ts, torch.from_numpy(x), 0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    check_step(ts, js, table, [3e-4])
    feats = tfgd.extract_features(ts, torch.from_numpy(x))
    want = np.asarray(jfgd.extract_features(js, jnp.asarray(x)))
    assert feats.shape == (B * 60, 512)
    np.testing.assert_allclose(feats.numpy(), want, rtol=1e-4, atol=1e-4)


def skeleton_states(monkeypatch, **kw):
    ts = tskeleton.create_state(0, **SKEL, device="cpu", **kw)
    C.no_dropout(ts.module)
    table = tp.skeleton_classifier_mapping(SKEL_LAYERS)
    js = jax_state(monkeypatch, JaxSkeleton,
                   C.jax_variables(ts.module, table),
                   jskeleton.create_state, **SKEL, **kw)
    return ts, js, table


def run_skeleton(monkeypatch, steps, **kw):
    C.patch_flax_dropout(monkeypatch)
    ts, js, table = skeleton_states(monkeypatch, **kw)
    step = fresh_jit(jskeleton.train_step)
    metrics = []
    for i in range(steps):
        x, y = poses(i, d=282), onehot(seed=i)
        js, jm = step(js, jnp.asarray(x), jnp.asarray(y),
                      jax.random.PRNGKey(i))
        ts, tm = tskeleton.train_step(ts, torch.from_numpy(x),
                                      torch.from_numpy(y), i)
        metrics.append(({k: float(v) for k, v in tm.items()},
                        {k: float(v) for k, v in jm.items()}))
    return ts, js, table, metrics


def test_skeleton_one_step(monkeypatch):
    ts, js, table, metrics = run_skeleton(monkeypatch, 1)
    (tm, jm), = metrics
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
    assert tm["acc"] == jm["acc"]
    check_step(ts, js, table, [3e-4])
    x = torch.from_numpy(poses(9))
    logits, mid = tskeleton.predict(ts, x)
    jl, jmid = jskeleton.predict(js, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert mid.shape == (B, 60, SKEL["d_model"])


def test_skeleton_warmup_three_steps(monkeypatch):
    """optax.linear_schedule(0, lr, 2) at the count before the update:
    updates at lr 0, lr / 2, lr. Update 0 leaves the weights as they were
    while Adam's moments move."""
    ts0 = tskeleton.create_state(0, **SKEL, device="cpu", warmup_steps=2)
    before = {k: v.clone() for k, v in ts0.module.state_dict().items()}
    lrs = [0.0, 1.5e-4, 3e-4]
    ts, js, table, metrics = run_skeleton(monkeypatch, 3, warmup_steps=2)
    for tm, jm in metrics:
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
    check_step(ts, js, table, lrs)
    assert [ts.lr_schedule(t) for t in range(4)] == [0.0] + lrs[1:] + [3e-4]
    # the first update alone: lr 0 keeps every weight
    one = tskeleton.create_state(0, **SKEL, device="cpu", warmup_steps=2)
    C.no_dropout(one.module)
    tskeleton.train_step(one, torch.from_numpy(poses(0)),
                         torch.from_numpy(onehot(seed=0)), 0)
    for k, v in one.module.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert one.optimizer.state[next(one.module.parameters())][
        "exp_avg"].abs().sum() > 0


def test_skeleton_grad_clip_three_steps(monkeypatch):
    """A clip far below the gradient's norm binds on every step: Adam's
    first moment after step 1 is 0.5 * the clipped gradient, of norm
    0.5 * clip, on both sides."""
    clip = 0.05
    ts, js, table, metrics = run_skeleton(monkeypatch, 1, grad_clip=clip)
    mu = C.snapshot(ts)["mu"]
    norm = float(torch.sqrt(sum((m.double() ** 2).sum()
                                for m in mu.values())))
    np.testing.assert_allclose(norm, 0.5 * clip, rtol=1e-5)
    check_step(ts, js, table, [3e-4])
    ts, js, table, metrics = run_skeleton(monkeypatch, 3, grad_clip=clip)
    for tm, jm in metrics:
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
    check_step(ts, js, table, [3e-4] * 3)


def test_clip_by_global_norm_matches_optax():
    """No epsilon, the factor max_norm / norm only where norm >= max_norm;
    torch.nn.utils.clip_grad_norm_ divides by norm + 1e-6 instead."""
    import optax

    r = np.random.RandomState(0)
    grads = [r.randn(5, 3).astype(np.float32), r.randn(7).astype(np.float32)]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads)))
    for max_norm in (0.5 * norm, norm, 2.0 * norm):
        got = clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                  max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    assert torch.equal(clip_by_global_norm([torch.ones(4)], 2.0)[0],
                       torch.ones(4))


@pytest.mark.parametrize("clip", [-1.0, -1e-3])
def test_negative_grad_clip_is_refused(clip):
    with pytest.raises(ValueError, match="grad_clip"):
        tskeleton.create_state(0, **SKEL, grad_clip=clip, device="cpu")


def test_cvae_one_step(monkeypatch):
    """L1 + 0.1 KL with train-mode BatchNorm writing its running statistics;
    the same reparameterisation noise on both sides."""
    feat_dim = 64
    C.patch_flax_dropout(monkeypatch)
    noise = np.random.RandomState(3).randn(B, 32).astype(np.float32)
    monkeypatch.setattr(
        jcvae_models, "_reparameterize",
        lambda rng, mu, logvar: jnp.asarray(noise) * jnp.exp(0.5 * logvar)
        + mu)
    ts = tcvae.create_state(0, feat_dim=feat_dim, device="cpu")
    C.no_dropout(ts.module)
    table = tp.cvae_v3_mapping()
    js = jax_state(monkeypatch, JaxCVAE, C.jax_variables(ts.module, table),
                   jcvae.create_state, feat_dim=feat_dim)
    x, y = poses(5, d=feat_dim), onehot(seed=5)
    js, jm = fresh_jit(jcvae.train_step, ("beta",))(js, jnp.asarray(x), jnp.asarray(y),
                                         jax.random.PRNGKey(0), beta=0.1)
    ts, tm = tcvae.train_step(ts, torch.from_numpy(x), torch.from_numpy(y),
                              0, beta=0.1, noise=torch.from_numpy(noise))
    for k in ("loss", "recon", "kl"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    check_step(ts, js, table, [2e-4], buffers=True)
    z = np.random.RandomState(4).randn(B, 32).astype(np.float32)
    got = tcvae.sample(ts, torch.from_numpy(y), 0, noise=torch.from_numpy(z))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(z))
    want = jcvae.sample(js, jnp.asarray(y), jax.random.PRNGKey(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_cvae_versions_1_and_2_are_refused():
    """v1 and v2 decode 512-wide features: refused at another width (the
    JAX step fails there on the L1 shapes); an unknown version too."""
    for version in (1, 2):
        with pytest.raises(ValueError, match="512"):
            tcvae.create_state(0, version=version, feat_dim=64, device="cpu")
    with pytest.raises(ValueError, match="version"):
        tcvae.create_state(0, version=4, device="cpu")


def test_plateau_detector_matches_jax():
    """The same accuracy trace gives the same reseeds and the same latch."""
    r = np.random.RandomState(0)
    trace = list(r.uniform(20, 30, 60)) + [45.0] * 20 + [10.0] * 60
    for kw in (dict(patience=10, window=5, max_reseeds=3),
               dict(patience=25, window=8, max_reseeds=8)):
        ours, theirs = (tskeleton.PlateauDetector(**kw),
                        jskeleton.PlateauDetector(**kw))
        got = [ours.update(a) for a in trace]
        want = [theirs.update(a) for a in trace]
        assert got == want and any(got)
        assert ours.attempts == theirs.attempts
        assert ours._converged and theirs._converged
    keys = {tskeleton.PlateauDetector().next_key(s) for s in (0, 1)}
    assert len(keys) == 2


def masks(model, x, seed, step):
    """The dropout draws of one train-mode forward under step_key(seed,
    step): every Dropout's keep mask."""
    drawn = []

    def hook(module, inputs, output):
        drawn.append((output != 0) | (inputs[0] == 0))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Dropout)]
    model.train()
    gen = torch.Generator().manual_seed(step_key(seed, step))
    try:
        with torch.no_grad(), dropout_generator(model, gen):
            model(*x)
    finally:
        for h in handles:
            h.remove()
        model.eval()
    return drawn


@pytest.mark.parametrize("name", ["fgd", "skeleton", "cvae"])
def test_dropout_follows_seed_and_step(name):
    """The three repaired models draw their masks from the generator the
    trainer hands them: the same (seed, step) gives the same masks, another
    step other masks, and torch's global generator is not used."""
    torch.manual_seed(0)
    model, x = {
        "fgd": lambda: (FGDAutoEncoder(device="cpu"),
                        (torch.randn(2, 60, 282),)),
        "skeleton": lambda: (SkeletonTransformer(**SKEL, device="cpu"),
                             (torch.randn(2, 60, 282),)),
        "cvae": lambda: (EmotionCVAEv3(feat_dim=64, device="cpu"),
                         (torch.randn(2, 60, 64), torch.eye(8)[:2],
                          torch.zeros(2, 32))),
    }[name]()
    kinds = {type(m) for m in model.modules()}
    assert torch.nn.Dropout not in kinds and Dropout in kinds
    a = masks(model, x, 1, 7)
    torch.manual_seed(123)  # the global generator must not matter
    b = masks(model, x, 1, 7)
    c = masks(model, x, 1, 8)
    assert a and len(a) == len(b) == len(c)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not all(torch.equal(u, v) for u, v in zip(a, c))
