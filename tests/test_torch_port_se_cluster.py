"""Host parts of kernel 3's bf16 path (`ops/fused_se_stage.py`) on the CPU.

The bf16 kernel holds one sample in a thread-block cluster: `cluster_layout`
splits H x W into n CTAs of R whole rows, and `pack_weights` repacks the
HWIO conv weights into the K-major (output, input channel) tiles its TMA
loads read. The kernel itself needs the card (tests marked `cuda` in
tests/test_torch_port_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from emotiongestures_torch.ops import fused_se_stage as FS


# (H, W) -> (R, n): the serving tail (124 of 128 GEMM rows), the JAX test's
# shape and the smallest card case (one CTA), a full 128-row tile, 2 columns,
# and the card cases whose last CTA is ragged (30 x 31, 3 x 64) or whose
# cluster is 3 CTAs (12 x 31)
@pytest.mark.parametrize("hw,layout", [((32, 31), (4, 8)), ((8, 9), (8, 1)),
                                       ((5, 7), (5, 1)), ((32, 32), (4, 8)),
                                       ((64, 2), (64, 1)), ((3, 64), (2, 2)),
                                       ((30, 31), (4, 8)), ((12, 31), (4, 3))])
def test_cluster_layout(hw, layout):
    R, n = FS.cluster_layout(*hw)
    assert (R, n) == layout
    assert R * hw[1] <= 128 and (n - 1) * R < hw[0] <= n * R
    assert FS.cluster_smem(R, hw[1]) <= FS.SMEM_LIMIT


def test_cluster_smem_counts_the_kernels_carve_up():
    """At 32 x 31 a CTA holds two 6 x 33 x 128 bf16 tiles (50,688 bytes
    each), a ring of 4 weight tiles of 128 x 64 bf16, the SE fc weights
    (2 x 128 x 16 bf16) and kBaseSmem's 9,040 bytes."""
    assert FS.cluster_smem(4, 31) == 2 * 50688 + 4 * 16384 + 8192 + 9040
    assert FS.cluster_smem(4, 31, 64) - FS.cluster_smem(4, 31, 16) == \
        4 * 128 * 48


@pytest.mark.parametrize("hw,match", [((4, 129), "W <= 128"),
                                      ((33, 32), "at most 8 CTAs"),
                                      ((65, 15), "at most 8 CTAs"),
                                      ((2, 128), "shared memory"),
                                      ((1, 103), "shared memory"),
                                      ((200, 1), "shared memory")])
def test_cluster_layout_refuses(hw, match):
    with pytest.raises(ValueError, match=match):
        FS.cluster_layout(*hw)


def test_pack_weights_round_trip():
    g = torch.Generator().manual_seed(0)
    w1 = torch.randn(3, 3, 3, 128, 128, generator=g).bfloat16()
    w2 = torch.randn(3, 3, 3, 128, 128, generator=g).bfloat16()
    wk = FS.pack_weights(w1, w2)
    assert wk.shape == (3, 2, 9, 128, 128) and wk.is_contiguous()
    assert wk.dtype == torch.bfloat16
    back = FS.unpack_weights(wk)
    assert torch.equal(back[0], w1) and torch.equal(back[1], w2)
    # conv c's tap (dh, dw) as (output, input channel)
    assert torch.equal(wk[2, 1, 5, 7, 3], w2[2, 1, 2, 3, 7])
    assert torch.equal(wk[0, 0, 0], w1[0, 0, 0].T)


def test_packed_taps_give_the_jax_convolution():
    """The 3x3 conv as the bf16 kernel computes it, 9 tap products of the
    zero-padded input with the K-major tiles, equals the JAX package's
    convolution (HWIO, SAME) of the same inputs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 7, 128)).astype(np.float32)
    w = (rng.standard_normal((1, 3, 3, 128, 128)) / 34).astype(np.float32)
    wk = FS.pack_weights(torch.from_numpy(w), torch.from_numpy(w))[0, 0]
    xp = F.pad(torch.from_numpy(x), (0, 0, 1, 1, 1, 1))
    got = torch.zeros(2 * 5 * 7, 128)
    for tap in range(9):
        a = xp[:, tap // 3:tap // 3 + 5, tap % 3:tap % 3 + 7].reshape(-1, 128)
        got += a @ wk[tap].T
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w[0]), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(got.view(2, 5, 7, 128).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_bf16_cpu_tensor_takes_plain_version():
    """A bf16 CPU tensor of a shape the kernel refuses still takes the
    plain version: the layout only binds the card."""
    g = torch.Generator().manual_seed(1)
    x = torch.relu(torch.randn(1, 2, 128, 128, generator=g)).bfloat16()
    ops = [torch.randn(1, 3, 3, 128, 128, generator=g) / 34,
           torch.ones(1, 128), torch.zeros(1, 128),
           torch.randn(1, 3, 3, 128, 128, generator=g) / 34,
           torch.ones(1, 128), torch.zeros(1, 128),
           torch.randn(1, 128, 16, generator=g) / 11, torch.zeros(1, 16),
           torch.randn(1, 16, 128, generator=g) / 4, torch.zeros(1, 128)]
    before = FS.launches
    got = FS.fused_se_stage(x, *ops)
    assert torch.equal(got, FS.fused_se_stage_plain(x, *ops))
    assert FS.launches == before
