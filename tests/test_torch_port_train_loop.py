"""Properties of the port's GAN train step that hold within the port, on
the CPU: the discriminator's concatenated pass, K steps against sequential
steps, rematerialised SE blocks, the per-step dropout generators, no
gradient from G's backward on D, and eval_step. Each compares two runs of
the port from the same seed.
"""
import copy

import numpy as np
import pytest
import torch
import torch_port_train_common as C
from torch_port_train_common import one_torch_thread  # noqa: F401

from emotiongestures_torch.core.layers import Dropout, dropout_generator
from emotiongestures_torch.models.discriminator import calc_motion
from emotiongestures_torch.train import gan
from emotiongestures_torch.train.state import finite_check

BATCH = C.torch_batch(C.make_batch(0, b=2))


def _states(dropout=True, **kw):
    cfg = gan.GANConfig(**C.SMALL, **kw)
    gs, ds = gan.create_states(cfg, 0, device="cpu")
    if not dropout:
        C.no_dropout(gs.module, ds.module)
    return cfg, gs, ds


def _assert_same_states(a, b, rtol=0.0, atol=0.0):
    for sa, sb in zip(a, b):
        assert sa.step == sb.step
        for (n, x), y in zip(sa.module.state_dict().items(),
                             sb.module.state_dict().values()):
            torch.testing.assert_close(x, y, rtol=rtol, atol=atol,
                                       msg=n)
        for pa, pb in zip(sa.module.parameters(), sb.module.parameters()):
            for key in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(sa.optimizer.state[pa][key],
                                           sb.optimizer.state[pb][key],
                                           rtol=rtol, atol=atol)


def test_d_concat_batch_equals_two_passes_without_dropout():
    """The discriminator has no BatchNorm: with dropout off, one 2B pass
    is two B passes (matmuls over other batch sizes: rtol 1e-5). The
    discriminator's update is held; the generator's then sees a D that
    differs in the last bits, and its SE-ResNet gradients are
    ill-conditioned (test_torch_port_train_dfirst.py)."""
    runs = []
    for concat in (False, True):
        cfg, gs, ds = _states(dropout=False, d_concat_batch=concat)
        gs, ds, m = gan.train_step(gs, ds, BATCH, 3, cfg)
        runs.append(((gs, ds), {k: float(v) for k, v in m.items()}))
    (a, ma), (b, mb) = runs
    for k in ma:
        np.testing.assert_allclose(ma[k], mb[k], rtol=1e-5, err_msg=k)
    _assert_same_states(a[1:], b[1:], rtol=1e-4, atol=1e-6)
    disc = a[1].module.eval()
    real, fake = (calc_motion(BATCH["pose_seq"]),
                  calc_motion(BATCH["pose_seq"].flip(0)))
    with torch.no_grad():
        both = disc(torch.cat([real, fake]))
        torch.testing.assert_close(both, torch.cat([disc(real), disc(fake)]),
                                   rtol=1e-5, atol=1e-6)


def test_train_steps_equals_sequential_steps():
    """K steps over (K, B, ...) batches are K train_step calls with the
    keys split from one, dropout on."""
    batches = {k: torch.stack([v, v.flip(0)]) for k, v in BATCH.items()}
    cfg, g1, d1 = _states()
    g2, d2 = copy.deepcopy(g1), copy.deepcopy(d1)
    g1, d1, stacked = gan.train_steps(g1, d1, batches, 11, cfg)
    seq = []
    for i, key in enumerate(gan.split_key(11, 2)):
        g2, d2, m = gan.train_step(g2, d2, {k: v[i] for k, v in
                                            batches.items()}, key, cfg)
        seq.append(m)
    for k, v in stacked.items():
        assert v.shape == (2,)
        torch.testing.assert_close(v, torch.stack([m[k] for m in seq]),
                                   rtol=0.0, atol=0.0)
    _assert_same_states((g1, d1), (g2, d2))
    assert g1.step == d1.step == 2


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_audio_gives_the_same_step(compute_dtype):
    """Checkpointed SE blocks recompute the same activations: the same
    gradients (Adam moments) and running statistics written once."""
    runs = []
    for remat in (False, True):
        cfg, gs, ds = _states(remat_audio=remat, compute_dtype=compute_dtype)
        gs, ds, m = gan.train_step(gs, ds, BATCH, 5, cfg)
        runs.append(((gs, ds), {k: float(v) for k, v in m.items()}))
    (a, ma), (b, mb) = runs
    assert ma == mb
    _assert_same_states(a, b, rtol=1e-5, atol=1e-7)


def test_dropout_draws_follow_the_step_key():
    """The same key gives the same step; another key other dropout
    draws. A resumed run draws what an uninterrupted one would: the key of
    step t is step_key(seed, t)."""
    cfg, g1, d1 = _states()
    g2, d2 = copy.deepcopy(g1), copy.deepcopy(d1)
    g3, d3 = copy.deepcopy(g1), copy.deepcopy(d1)
    _, _, m1 = gan.train_step(g1, d1, BATCH, gan.step_key(1, 7), cfg)
    _, _, m2 = gan.train_step(g2, d2, BATCH, gan.step_key(1, 7), cfg)
    _, _, m3 = gan.train_step(g3, d3, BATCH, gan.step_key(1, 8), cfg)
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}
    assert float(m1["g_rec"]) != float(m3["g_rec"])
    assert gan.step_key(1, 7) == gan.step_key(1, 7) != gan.step_key(2, 7)
    assert all(d.generator is None for d in g1.module.modules()
               if isinstance(d, Dropout))


@pytest.mark.parametrize("order", ["d_first", "g_first"])
def test_generator_backward_leaves_no_gradient_on_the_discriminator(order):
    cfg, gs, ds = _states(update_order=order)
    d_before = [p.detach().clone() for p in ds.module.parameters()]
    gs, ds, _ = gan.train_step(gs, ds, BATCH, 1, cfg, use_disc=False)
    assert all(p.grad is None for p in ds.module.parameters())
    assert all(torch.equal(a, p) for a, p in zip(d_before,
                                                   ds.module.parameters()))
    gs, ds, _ = gan.train_step(gs, ds, BATCH, 2, cfg)
    assert all(p.grad is None for p in ds.module.parameters())
    assert all(p.grad is None for p in gs.module.parameters())
    assert (gs.step, ds.step) == (2, 1)


def test_train_mode_forward_and_eval_step():
    """In train mode the generator returns the JAX 5-tuple, and eval_step
    runs it in eval mode and puts train mode back."""
    cfg, gs, _ = _states()
    gen = gs.module.train()
    with torch.no_grad(), dropout_generator(gen, torch.Generator()):
        out = gen(BATCH["spectrogram"], BATCH["text"],
                  BATCH["pose_seq"][:, :10])
    assert [tuple(t.shape) for t in out] == [
        (2, 60, 282), (2, 60, 64), (2, 60, 64), (2, 8), (2, 60, 512)]
    res = gan.eval_step(gs, BATCH, cfg)
    assert gen.training and res["pred"].shape == (2, 60, 282)
    with torch.no_grad():
        pred = gen.eval()(BATCH["spectrogram"], BATCH["text"],
                          BATCH["pose_seq"][:, :10])[0]
    torch.testing.assert_close(res["pred"], pred)
    want = torch.linalg.vector_norm(BATCH["pose_seq"] - pred, dim=-1).mean()
    torch.testing.assert_close(res["l2"], want)
    assert finite_check(gs)
    with torch.no_grad():
        next(gen.parameters())[0] = float("nan")
    assert not finite_check(gs)


def test_unknown_update_order_and_variant_are_refused():
    cfg, gs, ds = _states(update_order="both")
    with pytest.raises(ValueError, match="update_order"):
        gan.train_step(gs, ds, BATCH, 0, cfg)
    with pytest.raises(ValueError, match="variant"):
        gan.build_models(gan.GANConfig(variant="unknown"), device="cpu")
