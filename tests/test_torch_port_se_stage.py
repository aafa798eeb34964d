"""Kernel 3, the fused SE-ResNet stage, against the JAX package on the CPU.

The Pallas kernel runs in interpret mode, as tests/test_pallas_se.py runs
it, on the operands `stage_params_from_flax` stacks from a flax stage-3 tail
whose BatchNorm statistics one train-mode pass made non-trivial. The port's
plain version gets the same numpy operands, and the port's
`stage_params_from_module` gets the same weights through the port's
SEBasicBlocks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emotiongestures_tpu.ops.pallas_se_block import (
    fold_bn as jax_fold_bn,
    fused_se_stage as jax_fused_se_stage,
    stage_params_from_flax,
)
from emotiongestures_torch.nn.resnet_se import SEBasicBlock
from emotiongestures_torch.ops import fused_se_stage as FS
from emotiongestures_torch.utils import weights as W

B, H, WD, C, NB = 4, 8, 9, 128, 2
NAMES = [f"layer3_block{i + 1}" for i in range(NB)]


@pytest.fixture(scope="module")
def stage():
    import flax.linen as nn

    from emotiongestures_tpu.nn.resnet_se import SEBasicBlock as JaxBlock

    class Tail(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            for name in NAMES:
                x = JaxBlock(C, stride=1, has_downsample=False, train=train,
                             name=name)(x)
            return x

    x = np.random.RandomState(0).randn(B, H, WD, C).astype(np.float32)
    m = Tail()
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # one train-mode pass makes the running stats non-trivial
    _, mut = m.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
    stacked = [np.array(a) for a in stage_params_from_flax(
        v["params"], v["batch_stats"], NAMES)]
    return x, v, stacked


def _blocks(v):
    """The port's SEBasicBlocks with the flax tail's weights (strict)."""
    blocks = torch.nn.Sequential(*[SEBasicBlock(C, C) for _ in NAMES])
    table = []
    for i, name in enumerate(NAMES):
        jb = (name,)
        tp = str(i)
        W.conv(table, f"{tp}.conv1", jb + ("conv1",), bias=False)
        W.conv(table, f"{tp}.conv2", jb + ("conv2",), bias=False)
        W.batchnorm(table, f"{tp}.bn1", jb + ("bn1",))
        W.batchnorm(table, f"{tp}.bn2", jb + ("bn2",))
        W.linear(table, f"{tp}.se.fc.0", jb + ("se", "fc1"))
        W.linear(table, f"{tp}.se.fc.2", jb + ("se", "fc2"))
    blocks.load_state_dict(W.state_from_table(v, table), strict=True)
    return blocks.eval()


def test_plain_matches_pallas_fp32(stage):
    x, _, stacked = stage
    ref = np.asarray(jax_fused_se_stage(jnp.asarray(x), *map(jnp.asarray,
                                                             stacked),
                                        batch_tile=2, interpret=True))
    got = FS.fused_se_stage_plain(torch.from_numpy(x),
                                  *map(torch.from_numpy, stacked))
    assert got.dtype == torch.float32 and got.shape == (B, H, WD, C)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_plain_matches_pallas_bf16(stage):
    """x in bf16 makes bf16 the compute dtype on both sides: the same bf16
    operands, bf16 products summed in fp32, and four roundings to bf16 per
    block. Sums in another order can flip a rounding, one bf16 step (2^-8
    relative) of an activation, so the two are held to two steps of the
    output's magnitude: atol 2 * 2^-8 * max|ref|, rtol 0 (measured here:
    well under one step)."""
    x, _, stacked = stage
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_fused_se_stage(xb, *map(jnp.asarray, stacked),
                                        batch_tile=2, interpret=True),
                     np.float32)
    got = FS.fused_se_stage_plain(torch.from_numpy(x).to(torch.bfloat16),
                                  *map(torch.from_numpy, stacked))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 2 * 2.0 ** -8 * np.abs(ref).max(), err


def test_stage_params_from_module_match_flax(stage):
    _, v, stacked = stage
    ours = FS.stage_params_from_module(list(_blocks(v)))
    assert len(ours) == len(stacked) == 10
    for got, want in zip(ours, stacked):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_plain_matches_port_blocks(stage):
    """The stacked-operand stage equals the port's own SEBasicBlocks (NCHW,
    BatchNorm not folded) on the same input."""
    x, v, _ = stage
    blocks = _blocks(v)
    ops = FS.stage_params_from_module(list(blocks))
    xt = torch.from_numpy(x)
    got = FS.fused_se_stage_plain(xt, *ops)
    with torch.no_grad():
        ref = blocks(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_fold_bn_matches_jax():
    r = np.random.RandomState(1)
    scale = (r.rand(16) + 0.5).astype(np.float32)
    bias = r.randn(16).astype(np.float32)
    mean = r.randn(16).astype(np.float32)
    var = (r.rand(16) + 0.1).astype(np.float32)
    want = jax_fold_bn({"scale": scale, "bias": bias},
                       {"mean": mean, "var": var})
    got = FS.fold_bn(*map(torch.from_numpy, (scale, bias, mean, var)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    x = torch.from_numpy(r.randn(32, 16).astype(np.float32))
    direct = (x - torch.from_numpy(mean)) / torch.sqrt(
        torch.from_numpy(var) + 1e-5) * torch.from_numpy(scale) + \
        torch.from_numpy(bias)
    torch.testing.assert_close(x * got[0] + got[1], direct, rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensor_takes_plain_version(stage):
    x, _, stacked = stage
    ops = [torch.from_numpy(a) for a in stacked]
    before = FS.launches
    got = FS.fused_se_stage(torch.from_numpy(x), *ops)
    assert torch.equal(got, FS.fused_se_stage_plain(torch.from_numpy(x),
                                                     *ops))
    assert FS.launches == before


def test_stage_params_refuse_downsample_blocks():
    with pytest.raises(ValueError, match="stride-1"):
        FS.stage_params_from_module([SEBasicBlock(64, 128, stride=2)])
