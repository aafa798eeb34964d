"""The parts of the port's GAN trainer against the JAX package, at fp32 on
the CPU: every loss, the staged LR, Adam with coupled L2, BatchNorm's train
mode, and the two discriminators with their weight tables.

Tolerances:
  * losses rtol 1e-5, atol 1e-6: the same fp32 formulas;
  * Adam against optax on the same gradients: moments rtol 1e-5, atol
    1e-7; weights of unit scale atol 1e-6, a few fp32 ulps after five
    updates;
  * BatchNorm output rtol 1e-5, atol 1e-5 and running statistics rtol
    1e-6, atol 1e-7: fp32 sums over B*H*W in another order;
  * discriminators rtol 1e-4, atol 1e-5: an fp32 transformer, as
    tests/test_torch_port_modules.py holds the encoder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emotiongestures_tpu.core import layers as jlayers
from emotiongestures_tpu.core import losses as jlosses
from emotiongestures_tpu.core import schedules as jschedules
from emotiongestures_tpu.models import discriminator as jdisc
from emotiongestures_tpu.utils import torch_port as tp
from emotiongestures_torch.core import layers, losses, schedules
from emotiongestures_torch.models import discriminator as tdisc
from emotiongestures_torch.train.state import TrainState
from emotiongestures_torch.utils import weights as W

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(*arrays):
    return ([torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


def _loss_cases():
    r = np.random.RandomState(0)
    logits = r.randn(6, 8).astype(np.float32)
    labels = np.array([0, 0, 3, 5, 5, 7])
    feats = r.randn(6, 16).astype(np.float32)
    feats_b = r.randn(6, 16).astype(np.float32)
    alpha = r.uniform(0.5, 2.0, 8).astype(np.float32)
    a = r.randn(4, 5).astype(np.float32)
    b = r.randn(4, 5).astype(np.float32)
    mu = r.randn(4, 32).astype(np.float32)
    logvar = (0.3 * r.randn(4, 32)).astype(np.float32)
    real = r.randn(4, 1).astype(np.float32)
    fake = r.randn(4, 1).astype(np.float32)
    return {
        "cross_entropy": ((logits, labels), {}),
        "focal_loss": ((logits, labels), {}),
        "focal_loss_alpha": ((logits, labels, alpha),
                             {"gamma": 1.5, "reduction": "sum"}),
        "focal_loss_none": ((logits, labels), {"reduction": "none"}),
        "softmax_contrastive_loss": ((feats, feats_b), {}),
        "emotion_infonce": ((feats, labels), {}),
        "kl_divergence": ((mu, logvar), {}),
        "l1_loss": ((a, b), {}),
        "l2_loss": ((a, b), {}),
        "huber_loss": ((3 * a, b), {"delta": 1.0}),
        "bce_with_logits": ((real,), {"target": 0.3}),
        "gan_d_loss": ((real, fake), {}),
        "gan_g_loss": ((fake,), {}),
        "hinge_d_loss": ((real, fake), {}),
        "hinge_g_loss": ((fake,), {}),
        "lsgan_d_loss": ((real, fake), {}),
        "lsgan_g_loss": ((fake,), {}),
    }


@pytest.mark.parametrize("case", sorted(_loss_cases()))
def test_loss_matches_jax(case):
    args, kw = _loss_cases()[case]
    name = case.split("_alpha")[0].split("_none")[0]
    targs, jargs = _pair(*args)
    got = getattr(losses, name)(*targs, **kw)
    want = getattr(jlosses, name)(*jargs, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


def test_loss_gradients_match_jax():
    """The trainer differentiates the contrastive terms: their gradients
    agree too, clips without a same-label partner included."""
    (feats, feats_b), _ = _loss_cases()["softmax_contrastive_loss"]
    (_, labels), _ = _loss_cases()["emotion_infonce"]
    for name, extra in (("emotion_infonce", labels),
                        ("softmax_contrastive_loss", feats_b)):
        t = torch.from_numpy(feats).requires_grad_()
        getattr(losses, name)(t, torch.from_numpy(extra)).backward()
        g = jax.grad(getattr(jlosses, name))(jnp.asarray(feats),
                                             jnp.asarray(extra))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_staged_lr_matches_jax():
    ladder, jladder = schedules.staged_lr(2e-4), jschedules.staged_lr(2e-4)
    for epoch in range(0, 160):
        np.testing.assert_allclose(ladder(epoch), float(jladder(epoch)),
                                   rtol=1e-6, err_msg=str(epoch))


def test_staged_adam_lr_per_update_across_an_epoch_boundary():
    """optax evaluates the schedule at the count before it increments: with
    2 updates per epoch, update t runs at ladder(t // 2), so the ladder's
    step from epoch 15 to 16 lands between updates 31 and 32. The port's
    state sets each update's lr the same way; the trajectories agree."""
    spe, n = 2, 36
    r = np.random.RandomState(0)
    w0 = r.randn(5).astype(np.float32)
    grads = r.randn(n, 5).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    state = TrainState(torch.nn.Linear(1, 1), schedules.adam(
        [p], lr=2e-4, weight_decay=0.0), lr_schedule=schedules.staged_step_lr(
            2e-4, spe))
    state.module = torch.nn.ParameterList([p])
    tx = jschedules.adam_staged(2e-4, spe, weight_decay=0.0)
    jw, opt = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    lrs = []
    for t in range(n):
        state.apply_gradients([torch.from_numpy(grads[t])])
        lrs.append(state.optimizer.param_groups[0]["lr"])
        upd, opt = tx.update(jnp.asarray(grads[t]), opt, jw)
        jw = optax.apply_updates(jw, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw),
                                   rtol=1e-6, atol=1e-9, err_msg=str(t))
    assert lrs[31] == pytest.approx(2e-4) and lrs[32] == pytest.approx(4e-5)
    assert state.step == n


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_matches_optax(weight_decay):
    """Coupled L2: optax add_decayed_weights then scale_by_adam is torch's
    Adam(weight_decay=...), betas (0.5, 0.999)."""
    r = np.random.RandomState(1)
    shapes = [(4, 3), (3,)]
    w0 = [r.randn(*s).astype(np.float32) for s in shapes]
    params = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
    opt = schedules.adam(params, lr=1e-2, weight_decay=weight_decay)
    state = TrainState(torch.nn.ParameterList(params), opt)
    tx = jschedules.adam(lr=1e-2, weight_decay=weight_decay)
    jw = [jnp.asarray(w) for w in w0]
    jopt = tx.init(jw)
    for t in range(5):
        g = [r.randn(*s).astype(np.float32) for s in shapes]
        state.apply_gradients([torch.from_numpy(x) for x in g])
        upd, jopt = tx.update([jnp.asarray(x) for x in g], jopt, jw)
        jw = optax.apply_updates(jw, upd)
    adam = [s for s in jopt if hasattr(s, "mu")][0]
    for i, p in enumerate(params):
        st = opt.state[p]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw[i]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(adam.mu[i]), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(adam.nu[i]), rtol=1e-5,
                                   atol=1e-7)


def _bn_pair(shape, seed):
    """A port BatchNorm over dim 1 and flax's (features last) with the same
    scale, bias and running statistics."""
    r = np.random.RandomState(seed)
    c = shape[1]
    scale = (1 + 0.3 * r.randn(c)).astype(np.float32)
    bias = (0.2 * r.randn(c)).astype(np.float32)
    mean = (0.5 * r.randn(c)).astype(np.float32)
    var = r.uniform(0.5, 1.5, c).astype(np.float32)
    bn = layers.BatchNorm(c)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}
    x = (2.0 + 3.0 * r.randn(*shape)).astype(np.float32)
    return bn, variables, x


@pytest.mark.parametrize("shape", [(4, 6, 5, 7), (3, 10, 9)],
                         ids=["BCHW", "BCL"])
def test_batchnorm_train_mode_matches_flax(shape):
    bn, variables, x = _bn_pair(shape, seed=len(shape))
    out = bn.train()(torch.from_numpy(x))
    xj = jnp.moveaxis(jnp.asarray(x), 1, -1)
    yj, mutated = jlayers.BatchNorm(use_running_average=False).apply(
        variables, xj, mutable=["batch_stats"])
    np.testing.assert_allclose(out.detach().numpy(),
                               np.moveaxis(np.asarray(yj), -1, 1),
                               rtol=1e-5, atol=1e-5)
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6,
                               atol=1e-7)
    # the biased variance, not the unbiased one F.batch_norm would write
    n = x.size // x.shape[1]
    dims = tuple(i for i in range(x.ndim) if i != 1)
    biased = x.astype(np.float64).var(axis=dims)
    want = 0.9 * variables["batch_stats"]["BatchNorm_0"]["var"] + 0.1 * biased
    np.testing.assert_allclose(bn.running_var.numpy(), want, rtol=1e-5)
    assert not np.allclose(want, 0.9 * variables["batch_stats"][
        "BatchNorm_0"]["var"] + 0.1 * biased * n / (n - 1), rtol=1e-5)


def test_batchnorm_frozen_stats_writes_nothing():
    bn, _, x = _bn_pair((4, 6, 5, 7), seed=3)
    bn.train()
    before = [bn.running_mean.clone(), bn.running_var.clone()]
    with layers.frozen_stats(bn):
        y = bn(torch.from_numpy(x))
    assert torch.equal(bn.running_mean, before[0])
    assert torch.equal(bn.running_var, before[1])
    assert bn.write_stats
    assert torch.equal(y, bn(torch.from_numpy(x)))  # same batch statistics
    assert not torch.equal(bn.running_mean, before[0])


def test_batchnorm_eval_mode_unchanged():
    """Eval mode keeps its fused fp32 pass on the running statistics."""
    bn, variables, x = _bn_pair((4, 6, 5, 7), seed=5)
    with torch.no_grad():
        out = bn.eval()(torch.from_numpy(x))
    yj = jlayers.BatchNorm(use_running_average=True).apply(
        variables, jnp.moveaxis(jnp.asarray(x), 1, -1))
    np.testing.assert_allclose(out.numpy(),
                               np.moveaxis(np.asarray(yj), -1, 1),
                               rtol=1e-5, atol=1e-5)


def test_dropout_keeps_with_one_minus_p_and_rescales():
    d = layers.Dropout(0.25).train()
    x = torch.ones(20000)
    g = torch.Generator().manual_seed(0)
    with layers.dropout_generator(d, g):
        y = d(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    with layers.dropout_generator(d, torch.Generator().manual_seed(0)):
        assert torch.equal(d(x), y)  # the mask is the generator's
    assert d.generator is None
    assert torch.equal(d.eval()(x), x)


SMALL_DISC = dict(pose_dim=24, d_model=24, d_inner=32, n_head=2, d_k=8,
                  d_v=8)


@pytest.mark.parametrize("kind", ["motion", "pose"])
def test_discriminator_matches_jax(kind):
    r = np.random.RandomState(7)
    if kind == "motion":
        frames, n_layers = 9, 2
        jm = jdisc.MotionDiscriminator(frames=frames, **SMALL_DISC)
        tm = tdisc.MotionDiscriminator(frames=frames, **SMALL_DISC,
                                       device="cpu")
        to_state = W.motion_discriminator_state_from_jax
    else:
        frames, n_layers = 12, 3
        jm = jdisc.PoseDiscriminator(frames=frames, **SMALL_DISC)
        tm = tdisc.PoseDiscriminator(frames=frames, **SMALL_DISC,
                                     device="cpu")
        to_state = W.pose_discriminator_state_from_jax
    x = r.randn(3, frames, 24).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm.load_state_dict(to_state(variables, n_layers), strict=True)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_calc_motion_matches_jax():
    x = np.random.RandomState(0).randn(2, 6, 4).astype(np.float32)
    np.testing.assert_array_equal(
        tdisc.calc_motion(torch.from_numpy(x)).numpy(),
        np.asarray(jdisc.calc_motion(jnp.asarray(x))))


def test_discriminator_tables_match_jax_package():
    """The pose table is a copy of torch_port.pose_discriminator_mapping;
    the motion table is tests/test_torch_parity.py's mapping."""
    assert W.pose_discriminator_table() == tp.pose_discriminator_mapping()
    t = []
    tp._enc_layers(t, "encoder", ("encoder",), 2, "slf_attn")
    tp._seq_linears(t, "fc1", (), ("fc1",), (0,))
    tp._seq_linears(t, "fc2", (), ("fc2_0", "fc2_1", "fc2_2", "fc2_3",
                                   "fc2_4", "fc2_out"), (0, 2, 4, 6, 8, 10))
    assert W.motion_discriminator_table() == t
    assert set(k for k, _, _ in t) == set(
        tdisc.MotionDiscriminator(device="cpu").state_dict())


def test_attention_probability_dropout_stays_at_the_reference_value():
    """Full_model/SubLayers.py:25 pins the attention-probability dropout
    at 0.1 whatever the discriminator's dropout is."""
    disc = tdisc.MotionDiscriminator(frames=9, dropout=0.5, **SMALL_DISC,
                                     device="cpu")
    attn = disc.encoder.layer_stack[0].slf_attn
    assert attn.attn_dropout.p == 0.1 and attn.dropout.p == 0.5
