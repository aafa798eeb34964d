"""Two GAN train steps of the port against
emotiongestures_tpu.train.gan.train_step at fp32 on the CPU: update_order
g_first (one generator forward serves both updates; G's adversarial term
sees the pre-update discriminator), contrastive_mode emo_sem (the
reference's SoftmaxContrastiveLoss), the discriminator on. The tolerances
and their reasons are test_torch_port_train_dfirst.py's. Same weights
and batches, dropout off on both sides (BatchNorm keeps its batch
statistics). Step 2 starts the port from JAX's state after step 1, so it
holds the second update (Adam's count 2, the moments' and running
statistics' second update) on its own: run freely, the steps part where
Adam's first update flips the sign of a weight whose |g| is near eps.
"""
import pytest
import torch_port_train_common as C
from torch_port_train_common import one_torch_thread  # noqa: F401

from emotiongestures_torch.train import gan as tgan

CFG = tgan.GANConfig(**C.SMALL, update_order="g_first",
                     contrastive_mode="emo_sem")
ILL = "audio_encoder.feat_extractor."
ZERO_GRAD = "audio_encoder.final_conv1.bias"


def moment_tol(what, step, net):
    def tol(name):
        if name == ZERO_GRAD:
            return 0.0, {"mu": 1e-6, "nu": 1e-12}[what]
        if name.startswith(ILL):
            frac = 0.15
        elif net == "d" and step == 1:
            frac = 1e-2
        else:
            frac = 1e-4
        return 1e-4, lambda scale: frac * scale
    return tol


def table(net, gen_table):
    return gen_table if net == "g" else C.motion_discriminator_table()


@pytest.fixture(scope="module")
def run():
    with pytest.MonkeyPatch.context() as mp:
        return C.run_both(CFG, mp, steps=2, sync=True)


@pytest.mark.parametrize("step", [0, 1])
def test_losses(run, step):
    records, _ = run
    C.assert_metrics(records[step]["tm"], records[step]["jm"], rtol=1e-4)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("net", ["g", "d"])
@pytest.mark.parametrize("what", ["mu", "nu"])
def test_moments(run, step, net, what):
    records, gen_table = run
    r = records[step]
    C.assert_close(r[net], r["j" + net], table(net, gen_table), what,
                   moment_tol(what, step, net))


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("net", ["g", "d"])
def test_params(run, step, net):
    records, gen_table = run
    r = records[step]
    C.assert_close(r[net], r["j" + net], table(net, gen_table), "params",
                   lambda name: (0.0, 2.02 * CFG.lr))


@pytest.mark.parametrize("step", [0, 1])
def test_running_stats(run, step):
    records, gen_table = run
    r = records[step]
    C.assert_close(r["g"], r["jg"], gen_table, "buffers",
                   lambda name: (1e-4, 1e-6))


def test_step_counts(run):
    records, _ = run
    for i, r in enumerate(records):
        C.assert_counts(r["g"], r["jg"], i + 1)
        C.assert_counts(r["d"], r["jd"], i + 1)
