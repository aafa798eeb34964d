"""The port's GEMM formulations of the 3x3 conv (ops/conv_gemm.py) against
the JAX package's (ops/conv_gemm.py) and against F.conv2d, on the CPU:
fp32 within tests/test_conv_gemm.py's tolerance (rtol 1e-5, atol 1e-4),
bf16 operands summed in fp32 as the JAX versions' preferred_element_type
makes them, and the same refusals of bad shapes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from emotiongestures_torch.ops import conv_gemm as P
from emotiongestures_tpu.ops import conv_gemm as J

SHAPES = [(2, 8, 7, 16, 16), (1, 5, 5, 4, 12), (2, 6, 9, 8, 3)]


def _data(shape, seed=0):
    B, H, W, C, K = shape
    r = np.random.RandomState(seed)
    return (r.randn(B, H, W, C).astype(np.float32),
            (0.1 * r.randn(3, 3, C, K)).astype(np.float32))


def _conv2d(x, w):
    """F.conv2d on NHWC / HWIO, back to NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("impl", sorted(P.CONV3X3_IMPLS))
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_and_conv2d(impl, shape):
    x, w = _data(shape)
    got = P.CONV3X3_IMPLS[impl](torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (*x.shape[:3], w.shape[-1])
    want = np.asarray(J.CONV3X3_IMPLS[impl](jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    ref = _conv2d(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("impl", sorted(P.CONV3X3_IMPLS))
def test_bf16_sums_in_fp32_like_jax(impl):
    x, w = _data((2, 6, 6, 8, 8), 1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = P.CONV3X3_IMPLS[impl](xb, wb)
    assert got.dtype == torch.bfloat16
    want = J.CONV3X3_IMPLS[impl](jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(w, jnp.bfloat16))
    # the same fp32 sums of exact bf16 products, rounded to bf16 once: at
    # most one bf16 ulp apart where the two orders of summation round apart
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(np.asarray(want, np.float32))
                                   + 1e-30)) - 7)
    assert (diff <= ulp).all()
    ref = _conv2d(xb.float(), wb.float())
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=1e-2,
                               atol=1e-2)


def test_rejects_bad_shapes():
    x = torch.zeros(2, 4, 4, 3)
    with pytest.raises(ValueError):
        P.conv3x3_taps(x, torch.zeros(5, 5, 3, 4))
    with pytest.raises(ValueError):
        P.conv3x3_im2col(x, torch.zeros(3, 3, 7, 4))
    with pytest.raises(ValueError):
        P.conv3x3_taps(torch.zeros(4, 4, 3), torch.zeros(3, 3, 3, 4))
