"""The attention kernel's precision recipe, emulated on the CPU.

`csrc/attention.cu` runs every projection of the sublayer on the tensor
cores in TF32 (10 mantissa bits) and keeps fp32 accuracy by splitting each
fp32 operand x into hi = rna_tf32(x) and lo = rna_tf32(x - hi); a bf16
operand is exact in TF32 and stays whole. The products it sums in fp32:

    fp32 A, fp32 W:  A_lo W_hi + A_hi W_lo + A_hi W_hi
    fp32 A, bf16 W:  A_lo W + A_hi W
    bf16 A, bf16 W:  A W
    bf16 A, fp32 W:  A W_lo + A W_hi

and the core's Q K^T and P V, all fp32, take the three-term form. The
helpers below do the same in torch: TF32 rounding by bit mask (round to
nearest, ties away from zero, as cvt.rna.tf32.f32), products of TF32 values
(exact in fp32) summed in fp32. At the flagship widths (B = 2, 60 x 60,
d_model 512, 8 heads of 64) the recipe is held to the JAX Pallas kernel in
interpret mode within the tolerance of tests/test_pallas_attention.py, and
a single TF32 pass, and the two operand faults that chip_smoke.py plants,
are shown to miss that tolerance, so the tolerance tells them apart.

This is the recipe, not the kernel: the sums here round to nearest, where
the card's tensor cores sum each mma in their own way. The kernel itself is
held to its plain version on the card (`test_attention_kernel_matches_plain
_on_card` in tests/test_torch_port_kernels.py, and chip_smoke.py phase 2a).
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emotiongestures_tpu.ops.pallas_attention import fused_attention
from emotiongestures_torch.ops import fused_attention as FA

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_pallas_attention.py
B, L, D, H, DK = 2, 60, 512, 8, 64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties away from zero), as fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a, w, a_exact: bool, w_exact: bool, passes: str = "split"):
    """a (..., K) @ w (..., N, K)^T as the kernel computes it. `a_exact` /
    `w_exact`: the operand came from bf16, so it is whole in TF32.
    passes="single": one TF32 pass, both operands rounded, no lo terms."""
    wt = lambda x: x.transpose(-1, -2)
    if passes == "single":
        return tf32(a) @ wt(tf32(w))
    a_hi, a_lo = (a, None) if a_exact else split(a)
    w_hi, w_lo = (w, None) if w_exact else split(w)
    out = a_hi @ wt(w_hi)
    if w_lo is not None:
        out = a_hi @ wt(w_lo) + out
    if a_lo is not None:
        out = a_lo @ wt(w_hi) + out
    return out


def sublayer(q_in, kv_in, wq, wk, wv, wo, s, b, q_exact, w_exact,
             passes="split"):
    """The kernel's sublayer on fp32 tensors that hold the operands'
    values (bf16 ones widened): split projections, the core's Q K^T and
    P V split too (all fp32), softmax and LayerNorm in fp32."""
    Bq, Lq, _ = q_in.shape
    Lk = kv_in.shape[1]
    kv_exact = False  # keys are fp32 in every call the wrapper takes
    q = product(q_in, wq, q_exact, w_exact, passes) * (1.0 / math.sqrt(DK))
    k = product(kv_in, wk, kv_exact, w_exact, passes)
    v = product(kv_in, wv, kv_exact, w_exact, passes)
    q = q.view(Bq, Lq, H, DK).transpose(1, 2)
    k = k.view(Bq, Lk, H, DK).transpose(1, 2)
    v = v.view(Bq, Lk, H, DK).transpose(1, 2)
    p = torch.softmax(product(q, k, False, False, passes), dim=-1)
    ctx = product(p, v.transpose(-1, -2), False, False, passes)
    ctx = ctx.transpose(1, 2).reshape(Bq, Lq, H * DK)
    o = product(ctx, wo, False, w_exact, passes) + q_in
    mean = o.mean(-1, keepdim=True)
    var = ((o - mean) ** 2).mean(-1, keepdim=True)
    return (o - mean) * torch.rsqrt(var + 1e-6) * s + b


@functools.lru_cache(maxsize=None)
def operands(kind: str, qdtype: str, wdtype: str):
    """numpy inputs from a seed, rounded to their dtypes: the fp32 views the
    emulation takes (torch layout) and the JAX Pallas kernel's output."""
    r = np.random.RandomState(5)
    q = r.randn(B, L, D).astype(np.float32)
    kv = q if kind == "self" else r.randn(B, L, D).astype(np.float32)
    w = [(r.randn(D, H * DK) / np.sqrt(D)).astype(np.float32)
         for _ in range(3)]
    w.append((r.randn(H * DK, D) / np.sqrt(H * DK)).astype(np.float32))
    s = (1 + 0.1 * r.randn(D)).astype(np.float32)
    b = (0.1 * r.randn(D)).astype(np.float32)
    jq = jnp.asarray(q, qdtype)
    params = [jnp.asarray(x, wdtype) for x in (*w, s, b)]
    ref = np.asarray(fused_attention(jq, jnp.asarray(kv), *params,
                                     n_head=H, d_k=DK, interpret=True))
    as_t = lambda x: torch.from_numpy(np.array(x, np.float32))
    tw = [as_t(p) for p in params]
    tw = [t.T.contiguous() for t in tw[:4]] + tw[4:]
    return as_t(jq), as_t(kv), tw, ref


RECIPES = [  # (kind, query dtype, weight dtype)
    ("self", "float32", "float32"),
    ("self", "float32", "bfloat16"),
    ("cross", "float32", "float32"),
    ("cross", "float32", "bfloat16"),
    ("cross", "bfloat16", "bfloat16"),
    ("cross", "bfloat16", "float32"),
]


def test_tf32_rounding():
    """Round to nearest with 10 mantissa bits, ties away from zero; bf16
    values pass unchanged; hi + lo holds x to 2^-22 of |x|."""
    x = torch.tensor([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11),
                      1 + 3 * 2.0 ** -12, 3.0])
    want = torch.tensor([1.0, 1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10),
                         1 + 2.0 ** -10, 3.0])
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    yb = y.to(torch.bfloat16).float()
    assert torch.equal(tf32(yb), yb)
    hi, lo = split(y)
    assert ((hi + lo - y).abs() <= 2.0 ** -22 * y.abs()).all()
    assert (hi - y).abs().max() > 0  # the split is not a no-op


@pytest.mark.parametrize("kind,qdtype,wdtype", RECIPES,
                         ids=["-".join(r) for r in RECIPES])
def test_split_recipe_matches_pallas(kind, qdtype, wdtype):
    q, kv, w, ref = operands(kind, qdtype, wdtype)
    got = sublayer(q, kv, *w, q_exact=qdtype == "bfloat16",
                   w_exact=wdtype == "bfloat16")
    np.testing.assert_allclose(got.numpy(), ref, **ATTN_TOL)
    # and as close as the fp32 plain version
    plain = FA.fused_attention_plain(q, kv, *w, n_head=H, d_k=DK).numpy()
    assert np.abs(got.numpy() - ref).max() <= 2 * np.abs(plain - ref).max()


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_single_tf32_pass_misses_tolerance(wdtype):
    q, kv, w, ref = operands("self", "float32", wdtype)
    got = sublayer(q, kv, *w, q_exact=False, w_exact=wdtype == "bfloat16",
                   passes="single").numpy()
    assert not np.allclose(got, ref, **ATTN_TOL)
    assert np.abs(got - ref).max() > 1e-4


@pytest.mark.parametrize("fault", ["weights", "activations"])
def test_planted_precision_faults_miss_tolerance(fault):
    """chip_smoke.py phase 2a's planted faults: the kernel's exact recipe on
    operands rounded to TF32 before the call (the four weights in
    fp32; the activations with bf16 weights), against the unrounded
    reference. The check must reject both."""
    wdtype = "float32" if fault == "weights" else "bfloat16"
    q, kv, w, ref = operands("self", "float32", wdtype)
    if fault == "weights":
        w = [tf32(t) for t in w[:4]] + w[4:]
    else:
        q = kv = tf32(q)
    got = sublayer(q, kv, *w, q_exact=False,
                   w_exact=wdtype == "bfloat16").numpy()
    assert not np.allclose(got, ref, **ATTN_TOL)
