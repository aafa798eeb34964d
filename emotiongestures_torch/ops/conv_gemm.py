"""GEMM formulations of the stride-1 SAME 3x3 convolution (port of
emotiongestures_tpu/ops/conv_gemm.py).

Both keep the conv's semantics exactly: NHWC input, the HWIO kernel that
flax stores (and that `fused_se_stage` takes), zero-padded SAME borders,
and the JAX versions' `preferred_element_type=float32`: bf16 operands are
multiplied exactly and summed in fp32 (here by upcasting them, since torch
has no bf16 x bf16 -> fp32 matmul on the CPU), and the result is cast back
to the input's dtype.

  * ``conv3x3_taps``   - 9 accumulated (B*H*W, C) @ (C, K) products, one
    per filter tap, on shifted slices of the padded input.
  * ``conv3x3_im2col`` - the (B*H*W, 9C) patch matrix, then ONE product
    with reduction dimension 9C.

They are plain `torch.matmul` products, as the JAX package computes them
outside any Pallas kernel; `chip_smoke.py` times both against
`F.conv2d` at the audio encoder's stage-3 shape.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[-1]:
        raise ValueError(f"expected NHWC x and (3,3,C,K) w, got "
                         f"{tuple(x.shape)} / {tuple(w.shape)}")


def _padded(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 1, 1, 1))


def conv3x3_taps(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv as 9 accumulated tap GEMMs.

    x: (B, H, W, C) channel-last; w: (3, 3, C, K) HWIO. Returns
    (B, H, W, K) in x's dtype."""
    _check(x, w)
    B, H, W, C = x.shape
    K = w.shape[-1]
    xp = _padded(x)
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + H, dx:dx + W, :].reshape(B * H * W, C)
            y = torch.matmul(tap.float(), w[dy, dx].float())
            acc = y if acc is None else acc + y
    return acc.to(x.dtype).reshape(B, H, W, K)


def conv3x3_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv as one (B*H*W, 9C) @ (9C, K) GEMM."""
    _check(x, w)
    B, H, W, C = x.shape
    K = w.shape[-1]
    xp = _padded(x)
    taps = [xp[:, dy:dy + H, dx:dx + W, :]
            for dy in range(3) for dx in range(3)]
    patches = torch.cat(taps, dim=-1).reshape(B * H * W, 9 * C)
    y = torch.matmul(patches.float(), w.reshape(9 * C, K).float())
    return y.to(x.dtype).reshape(B, H, W, K)


CONV3X3_IMPLS = {"taps": conv3x3_taps, "im2col": conv3x3_im2col}
