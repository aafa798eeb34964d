"""Fused eval-mode post-LN attention sublayer: the CUDA kernel
`csrc/attention.cu` and its plain PyTorch version.

Replaces the TPU kernel emotiongestures_tpu/ops/pallas_attention.py::
_mha_kernel (driven there by fused_attention and fused_self_attention, and
routed from nn/transformer.py). One call computes, per batch element,

    LayerNorm(concat_h softmax(q_in Wq_h^T (kv_in Wk_h^T)^T / sqrt(d_k))
              kv_in Wv_h^T) Wo^T + q_in),  eps 1e-6

with fp32 sums whatever the input types, and returns fp32. The kernel is
three launches, all on the tensor cores: the Q/K/V projections as tiled
GEMMs into a head-major fp32 scratch, the per-head softmax attention into
a context scratch, and the output projection with the residual and
LayerNorm. Each product splits its fp32 operands into two TF32 terms
(hi + lo; a bf16 operand is exact in TF32 and stays whole) and sums the
products that matter in fp32, which keeps it within the TPU kernel's
tolerance, where a single TF32 or bf16 pass would miss it. Each 8-deep
k-step is summed in a fresh accumulator and added to the running sum by
fp32 adds, since the tensor cores' own running sum is ~10x less exact. The
recipe per operand type and the bounds (0.44 ms for fp32-accurate
products on the tensor cores against 2.04 ms in plain fp32 FMA at B=1024,
L=60, d_model=512) are in the header of `csrc/attention.cu`.

Weights are in torch.nn.Linear layout: wq, wk, wv (H*d_k, d_model), wo
(d_model, H*d_k). `fused_attention` is the wrapper: a CPU tensor takes
`fused_attention_plain`; a CUDA tensor launches the kernel or raises. It
allocates both scratch tensors. `launches` counts sublayer calls that went
to the kernel, one per call whatever the number of CUDA launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_lib

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_plain(q_in, kv_in, wq, wk, wv, wo, ln_scale, ln_bias,
                          n_head: int, d_k: int) -> torch.Tensor:
    """The sublayer as the TPU kernel computes it, in fp32 torch ops."""
    f = torch.float32
    x, kv = q_in.to(f), kv_in.to(f)
    B, Lq, _ = x.shape
    Lk = kv.shape[1]
    q = (x @ wq.to(f).T).view(B, Lq, n_head, d_k).transpose(1, 2)
    k = (kv @ wk.to(f).T).view(B, Lk, n_head, d_k).transpose(1, 2)
    v = (kv @ wv.to(f).T).view(B, Lk, n_head, d_k).transpose(1, 2)
    scores = (q * (1.0 / math.sqrt(d_k))) @ k.transpose(-1, -2)
    ctx = torch.softmax(scores, dim=-1) @ v  # (B, H, Lq, d_k)
    o = ctx.transpose(1, 2).reshape(B, Lq, n_head * d_k) @ wo.to(f).T + x
    mean = o.mean(-1, keepdim=True)
    var = ((o - mean) ** 2).mean(-1, keepdim=True)
    normed = (o - mean) * torch.rsqrt(var + 1e-6)
    return normed * ln_scale.to(f) + ln_bias.to(f)


def _check(q_in, kv_in, weights, n_head, d_k):
    dev = q_in.device
    B, Lq, D = q_in.shape
    if kv_in.ndim != 3 or kv_in.shape[0] != B or kv_in.shape[2] != D:
        raise ValueError(f"fused_attention: kv_in {tuple(kv_in.shape)} does "
                         f"not match q_in {tuple(q_in.shape)}")
    Lk = kv_in.shape[1]
    HD = n_head * d_k
    if not (0 < Lq <= 64 and 0 < Lk <= 64 and 0 < d_k <= 64 and d_k % 4 == 0
            and D % 128 == 0 and D <= 512 and HD % 32 == 0):
        raise ValueError(
            "fused_attention: the kernel takes Lq, Lk, d_k <= 64, d_k % 4 == "
            f"0, d_model in (128, 256, 384, 512), H*d_k % 32 == 0; got "
            f"Lq={Lq} Lk={Lk} d_model={D} H={n_head} d_k={d_k}")
    wq, wk, wv, wo, s, b = weights
    shapes = [(wq, (HD, D)), (wk, (HD, D)), (wv, (HD, D)), (wo, (D, HD)),
              (s, (D,)), (b, (D,))]
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_attention: weight {tuple(t.shape)} != "
                             f"{shape}")
    wdt = wq.dtype
    for t in (q_in, kv_in, *weights):
        if t.device != dev:
            raise ValueError("fused_attention: all tensors must be on "
                             f"{dev}, one is on {t.device}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"fused_attention: dtype {t.dtype} not taken")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused_attention: tensors must be contiguous "
                             "and 16-byte aligned")
    if any(t.dtype != wdt for t in weights):
        raise ValueError("fused_attention: weights and LayerNorm params "
                         "must share one dtype")
    if kv_in.dtype != torch.float32:
        # the serving path's keys are always fp32 (the encoder's stream);
        # the kernel is built for fp32 keys only
        raise ValueError(f"fused_attention: kv_in must be float32, got "
                         f"{kv_in.dtype}")
    return B, Lq, Lk, D


def fused_attention(q_in, kv_in, wq, wk, wv, wo, ln_scale, ln_bias,
                    n_head: int = 8, d_k: int = 64) -> torch.Tensor:
    """One post-LN attention sublayer, self- or cross-attention.
    q_in (B, Lq, D) fp32 or bf16 is also the residual; kv_in (B, Lk, D)
    fp32 on the card. Returns fp32 (B, Lq, D)."""
    global launches
    if q_in.device.type == "cpu":
        return fused_attention_plain(q_in, kv_in, wq, wk, wv, wo, ln_scale,
                                     ln_bias, n_head, d_k)
    if q_in.device.type != "cuda":
        raise RuntimeError(f"fused_attention: no kernel for {q_in.device}")
    weights = (wq, wk, wv, wo, ln_scale, ln_bias)
    B, Lq, Lk, D = _check(q_in, kv_in, weights, n_head, d_k)
    dev = q_in.device
    qkv = torch.empty(B * n_head * (Lq + 2 * Lk) * d_k, device=dev)
    ctx = torch.empty(B, Lq, n_head * d_k, device=dev)
    out = torch.empty(B, Lq, D, device=dev)
    lib = cuda_lib.load("attention")
    p = ctypes.c_void_p
    code = lib.eg_attention(
        p(q_in.data_ptr()), _DTYPES[q_in.dtype], p(kv_in.data_ptr()),
        p(wq.data_ptr()), p(wk.data_ptr()),
        p(wv.data_ptr()), p(wo.data_ptr()), p(ln_scale.data_ptr()),
        p(ln_bias.data_ptr()), _DTYPES[wq.dtype], p(qkv.data_ptr()),
        p(ctx.data_ptr()), p(out.data_ptr()), B, Lq, Lk, D, n_head, d_k,
        p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_lib.check_launch(code, "attention kernel")
    launches += 1
    return out
