"""Mixed precision in the port's GAN trainer against the JAX package's, on
the CPU: compute_dtype bfloat16 (fp32 master parameters and Adam state,
forward and backward on a bf16 copy), update_order d_first, the
discriminator on, dropout off on both sides.

Tolerances, and why:
  * losses: rtol 1e-2 (read: at most 4.4e-3, the InfoNCE term; the others
    within 7e-5). Both sides round to bf16 at different points.
  * Adam moments: bf16 gradients are noisy in both packages. Against their
    own fp32 step, the port's and JAX's bf16 first moments both sit a
    median 0.11-0.13 (discriminator) and 0.24-0.26 (generator) away in
    relative norm. So the port is held to JAX at a median relative-norm
    distance below 0.5 per network, and each moment must be fp32 and
    finite.
"""
import jax
import numpy as np
import pytest
import torch
import torch_port_train_common as C
from torch_port_train_common import one_torch_thread  # noqa: F401

from emotiongestures_tpu.train import gan as jgan
from emotiongestures_torch.train import gan as tgan

CFG = tgan.GANConfig(**C.SMALL, compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def run():
    with pytest.MonkeyPatch.context() as mp:
        records, gen_table = C.run_both(CFG, mp, steps=1)
    return records[0], gen_table


def test_losses(run):
    r, _ = run
    C.assert_metrics(r["tm"], r["jm"], rtol=1e-2)


@pytest.mark.parametrize("net", ["g", "d"])
@pytest.mark.parametrize("what", ["mu", "nu"])
def test_moments(run, net, what):
    r, gen_table = run
    table = gen_table if net == "g" else C.motion_discriminator_table()
    ref = C.reference(r["j" + net], table, what)
    dists = []
    for name, got in r[net][what].items():
        assert got.dtype == torch.float32, name
        assert torch.isfinite(got).all(), name
        want = ref[name]
        if np.linalg.norm(want) > 0:
            dists.append(np.linalg.norm(got.double().numpy() - want)
                         / np.linalg.norm(want))
    assert np.median(dists) < 0.5, np.median(dists)


def test_master_weights_and_running_stats_stay_fp32(run):
    r, _ = run
    for net in ("g", "d"):
        for name, t in {**r[net]["params"], **r[net]["buffers"]}.items():
            assert t.dtype == torch.float32, name


def test_grad_dtype_requires_bf16_compute():
    """Both packages refuse grad_dtype bfloat16 without bf16 compute."""
    cfg = tgan.GANConfig(**C.SMALL, grad_dtype="bfloat16")
    gs, ds = tgan.create_states(cfg, 0, device="cpu")
    batch = C.torch_batch(C.make_batch(0, b=2))
    with pytest.raises(ValueError, match="requires compute_dtype"):
        tgan.train_step(gs, ds, batch, 0, cfg)
    assert gs.step == ds.step == 0
    jcfg = jgan.GANConfig(**C.SMALL, grad_dtype="bfloat16")
    with pytest.raises(ValueError, match="requires compute_dtype"):
        jgan.train_step.__wrapped__(
            None, None, C.jax_batch(C.make_batch(0, b=2)),
            jax.random.PRNGKey(0), jcfg, True)


def test_bf16_gradients_upcast_at_adam():
    """grad_dtype bfloat16: gradients taken with respect to the bf16 copy;
    Adam's moments and the master weights stay fp32 and finite, and the
    step's losses match the fp32-gradient step's (the forward is the
    same)."""
    batch = C.torch_batch(C.make_batch(0, b=2))
    metrics = {}
    for grad_dtype in ("float32", "bfloat16"):
        cfg = tgan.GANConfig(**C.SMALL, compute_dtype="bfloat16",
                             grad_dtype=grad_dtype)
        gs, ds = tgan.create_states(cfg, 0, device="cpu")
        gs, ds, m = tgan.train_step(gs, ds, batch, 0, cfg)
        metrics[grad_dtype] = {k: float(v) for k, v in m.items()}
        for state in (gs, ds):
            for p in state.module.parameters():
                st = state.optimizer.state[p]
                assert p.dtype == st["exp_avg"].dtype == torch.float32
                assert torch.isfinite(st["exp_avg"]).all()
    for k, v in metrics["float32"].items():
        np.testing.assert_allclose(metrics["bfloat16"][k], v, rtol=1e-6,
                                   err_msg=k)
