"""A warm-up GAN train step (use_disc=False: no discriminator update, no
adversarial term) of the port against emotiongestures_tpu.train.gan.
train_step in float64 on the CPU: the JAX side under jax.enable_x64, the
port's modules in double, dropout off on both sides.

At fp32 the gradients of the audio encoder's SE-ResNet are ill-conditioned
in both packages (test_torch_port_train_dfirst.py). In float64 every
tensor is held to 1e-4 of its scale, which checks the port's train-mode
BatchNorm backward through all 13 SE blocks. Both packages still compute
the loss terms in fp32 (the JAX step upcasts model outputs with an explicit
astype(float32), and the port mirrors it), which leaves fp32 rounding in the
gradients.

Tolerances, and why:
  * losses: rtol 1e-4 (read: at most 3.4e-6, the fp32 loss arithmetic).
  * Adam moments (mu = 0.5 g, nu = 0.001 g^2): rtol 1e-4, atol 1e-4 of the
    tensor's largest entry (read: at most 4.3e-5 of it). final_conv1.bias
    feeds a train-mode BatchNorm: its exact gradient is zero, mu within
    atol 1e-6, nu within 1e-12.
  * parameters: atol 2.02 * lr. Adam's first update is about
    lr * sign(g): where |g| is near eps, any difference in g can flip it
    (1% over 2 * lr for the rounding of the weights).
  * running statistics: rtol 1e-4, atol 1e-6.
"""
import numpy as np
import pytest
import torch_port_train_common as C
from torch_port_train_common import one_torch_thread  # noqa: F401

from emotiongestures_torch.train import gan as tgan

CFG = tgan.GANConfig(**C.SMALL, update_order="d_first",
                     contrastive_mode="paired_label")
ZERO_GRAD = "audio_encoder.final_conv1.bias"


def moment_tol(what):
    def tol(name):
        if name == ZERO_GRAD:
            return 0.0, {"mu": 1e-6, "nu": 1e-12}[what]
        return 1e-4, lambda scale: 1e-4 * scale
    return tol


@pytest.fixture(scope="module")
def run():
    with pytest.MonkeyPatch.context() as mp:
        records, gen_table = C.run_both(CFG, mp, steps=1, use_disc=False,
                                        float64=True)
    return records[0], gen_table


def test_losses(run):
    r, _ = run
    C.assert_metrics(r["tm"], r["jm"], rtol=1e-4)
    assert r["tm"]["d_loss"] == r["tm"]["g_adv"] == 0.0


@pytest.mark.parametrize("what", ["mu", "nu"])
def test_moments(run, what):
    r, gen_table = run
    C.assert_close(r["g"], r["jg"], gen_table, what, moment_tol(what))


def test_params(run):
    r, gen_table = run
    C.assert_close(r["g"], r["jg"], gen_table, "params",
                   lambda name: (0.0, 2.02 * CFG.lr))


def test_running_stats(run):
    r, gen_table = run
    C.assert_close(r["g"], r["jg"], gen_table, "buffers",
                   lambda name: (1e-4, 1e-6))


def test_discriminator_untouched(run):
    """The warm-up leaves D as it was on both sides: step 0, no Adam
    state, the initial weights."""
    r, _ = run
    assert r["d"]["step"] == int(r["jd"].step) == 0
    assert not r["d"]["mu"]
    ref = C.reference(r["jd"], C.motion_discriminator_table(), "params")
    for name, p in r["d"]["params"].items():
        np.testing.assert_array_equal(p.numpy(), ref[name], err_msg=name)


def test_step_counts(run):
    r, _ = run
    C.assert_counts(r["g"], r["jg"], 1)
