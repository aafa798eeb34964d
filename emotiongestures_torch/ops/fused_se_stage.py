"""Fused SE-ResNet stage: the CUDA kernel `csrc/se_stage.cu` and its plain
PyTorch version.

Replaces the TPU kernel emotiongestures_tpu/ops/pallas_se_block.py::
_stage_kernel (driven there by fused_se_stage, with the helpers fold_bn and
stage_params_from_flax). One call runs N stride-1 SEBasicBlocks in eval mode
(Full_model/ResNetBlocks.py:12-37, with the reference's conv -> relu -> bn
order in the first leg), NHWC:

    y    = relu(conv3x3(x, w1)) * s1 + t1          -> x's dtype
    z    = conv3x3(y, w2) * s2 + t2                 (fp32)
    gate = sigmoid(relu(mean_hw(z) @ f1w + f1b) @ f2w + f2b)
    x    = relu(z * gate + x)                       -> x's dtype

with BatchNorm folded to per-channel affines (`fold_bn`). The layout and
signature are the JAX function's: x (B, H, W, C); w1, w2 (NB, 3, 3, C, C)
HWIO; s1, t1, s2, t2 (NB, C); f1w (NB, C, C/8), f1b (NB, C/8), f2w
(NB, C/8, C), f2b (NB, C). x's dtype (fp32 or bf16) is the compute dtype:
weights are cast to it, products accumulate in fp32, and bn1's output, the SE
fc inputs and the output are rounded to it.

The JAX package's serving path never calls the TPU kernel (it lost to XLA's
convolutions, pallas_se_block.py:23-30), and `GestureTransformer` here does
not call this one either: the audio encoder's stage-3 tail runs on cuDNN.
`stage_params_from_module` stacks the operands from the port's own blocks,
so the kernel can be held against them.

`fused_se_stage` is the wrapper: a CPU tensor takes `fused_se_stage_plain`;
a CUDA tensor launches the kernel (3 launches per block, one C call; fp32
convs as fp32 FMA, bf16 convs on the tensor cores) or raises. `launches`
counts the calls that went to the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from . import cuda_lib

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_CHANNELS = 128    # the kernel's channel count (its N tile)
TILE_PIXELS = 128        # output pixels per conv block (csrc/se_stage.cu kBM)
MAX_HIDDEN = 64


def fold_bn(weight, bias, running_mean, running_var, eps: float = 1e-5):
    """Eval-mode BatchNorm as a per-channel affine: (scale, shift), fp32."""
    scale = weight.float() / torch.sqrt(running_var.float() + eps)
    shift = bias.float() - running_mean.float() * scale
    return scale, shift


def stage_params_from_module(blocks: Sequence[torch.nn.Module]):
    """The 10 stacked operands `fused_se_stage` takes after x, from stride-1
    `nn.resnet_se.SEBasicBlock`s without downsample: torch's OIHW conv
    weights become HWIO, the SE Linears' (out, in) weights (in, out)."""
    cols = [[] for _ in range(10)]
    with torch.no_grad():
        for blk in blocks:
            if blk.downsample is not None or blk.conv1.stride != (1, 1):
                raise ValueError("stage_params_from_module: the fused stage "
                                 "takes stride-1 blocks without downsample")
            fc1, fc2 = blk.se.fc[0], blk.se.fc[2]
            s1, t1 = fold_bn(blk.bn1.weight, blk.bn1.bias,
                             blk.bn1.running_mean, blk.bn1.running_var,
                             blk.bn1.eps)
            s2, t2 = fold_bn(blk.bn2.weight, blk.bn2.bias,
                             blk.bn2.running_mean, blk.bn2.running_var,
                             blk.bn2.eps)
            ops = (blk.conv1.weight.permute(2, 3, 1, 0), s1, t1,
                   blk.conv2.weight.permute(2, 3, 1, 0), s2, t2,
                   fc1.weight.T, fc1.bias, fc2.weight.T, fc2.bias)
            for col, t in zip(cols, ops):
                col.append(t)
        return tuple(torch.stack(col).contiguous() for col in cols)


def _operands(x, w1, s1, t1, w2, s2, t2, f1w, f1b, f2w, f2b):
    """Weights in x's dtype, affines and biases in fp32, all contiguous (the
    JAX wrapper's casts)."""
    cd, f = x.dtype, torch.float32
    return ([t.to(cd).contiguous() for t in (w1, w2, f1w, f2w)],
            [t.to(f).contiguous() for t in (s1, t1, s2, t2, f1b, f2b)])


def fused_se_stage_plain(x, w1, s1, t1, w2, s2, t2, f1w, f1b, f2w, f2b):
    """The stage as the TPU kernel computes it: each 3x3 conv as 9 tap
    products in fp32 over x's-dtype operands, with its casts."""
    (w1, w2, f1w, f2w), (s1, t1, s2, t2, f1b, f2b) = _operands(
        x, w1, s1, t1, w2, s2, t2, f1w, f1b, f2w, f2b)
    cd, f = x.dtype, torch.float32
    B, H, W, C = x.shape
    M = B * H * W

    def conv3x3(inp, w):  # inp (B, H, W, C) of dtype cd; w (3, 3, C, C)
        xp = F.pad(inp, (0, 0, 1, 1, 1, 1))
        acc = torch.zeros(M, w.shape[-1], dtype=f, device=inp.device)
        for dh in range(3):
            for dw in range(3):
                a = xp[:, dh:dh + H, dw:dw + W, :].reshape(M, C)
                acc += a.to(f) @ w[dh, dw].to(f)
        return acc

    for i in range(w1.shape[0]):
        y = torch.relu(conv3x3(x, w1[i])) * s1[i] + t1[i]
        z = conv3x3(y.to(cd).view(B, H, W, C), w2[i]) * s2[i] + t2[i]
        z = z.view(B, H * W, C)
        pool = z.mean(dim=1)
        hid = torch.relu(pool.to(cd).to(f) @ f1w[i].to(f) + f1b[i])
        gate = torch.sigmoid(hid.to(cd).to(f) @ f2w[i].to(f) + f2b[i])
        res = x.reshape(B, H * W, C).to(f)
        x = torch.relu(z * gate[:, None, :] + res).to(cd).view(B, H, W, C)
    return x


def _check(x, w1, f1w, tensors):
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_se_stage: dtype {x.dtype} not taken")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("fused_se_stage: x must be a contiguous (B, H, W, C) "
                         "tensor (NHWC: permute(0, 2, 3, 1).contiguous())")
    B, H, W, C = x.shape
    NB, hidden = w1.shape[0], f1w.shape[-1]
    if C != KERNEL_CHANNELS or not 1 <= hidden <= MAX_HIDDEN \
            or not 1 <= B <= 65535 or NB < 1:
        raise ValueError(
            f"fused_se_stage: the kernel takes C == {KERNEL_CHANNELS}, "
            f"1 <= C/8 <= {MAX_HIDDEN}, 1 <= B <= 65535, NB >= 1; got "
            f"x {tuple(x.shape)}, NB {NB}, hidden {hidden}")
    (w1, w2, f1w, f2w), (s1, t1, s2, t2, f1b, f2b) = tensors
    shapes = [(w1, (NB, 3, 3, C, C)), (w2, (NB, 3, 3, C, C)),
              (f1w, (NB, C, hidden)), (f2w, (NB, hidden, C)),
              (s1, (NB, C)), (t1, (NB, C)), (s2, (NB, C)), (t2, (NB, C)),
              (f1b, (NB, hidden)), (f2b, (NB, C))]
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_se_stage: operand {tuple(t.shape)} != "
                             f"{shape}")
        if t.device != x.device:
            raise ValueError(f"fused_se_stage: all tensors must be on "
                             f"{x.device}, one is on {t.device}")
    return B, H, W, C, NB, hidden


def fused_se_stage(x, w1, s1, t1, w2, s2, t2, f1w, f1b, f2w, f2b):
    """NB stride-1 SEBasicBlocks, eval mode, NHWC. Returns (B, H, W, C) in
    x's dtype. On the card x must be contiguous with C == 128."""
    global launches
    if x.device.type == "cpu":
        return fused_se_stage_plain(x, w1, s1, t1, w2, s2, t2, f1w, f1b,
                                    f2w, f2b)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_se_stage: no kernel for {x.device}")
    tensors = _operands(x, w1, s1, t1, w2, s2, t2, f1w, f1b, f2w, f2b)
    B, H, W, C, NB, hidden = _check(x, w1, f1w, tensors)
    (w1, w2, f1w, f2w), (s1, t1, s2, t2, f1b, f2b) = tensors
    tiles = -(-H * W // TILE_PIXELS)
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if NB > 1 else out
    y1 = torch.empty_like(x)
    z = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    partial = torch.empty(B, tiles, C, dtype=torch.float32, device=x.device)
    lib = cuda_lib.load("se_stage")
    p = ctypes.c_void_p
    code = lib.eg_se_stage(
        p(x.data_ptr()), _DTYPES[x.dtype], p(out.data_ptr()),
        p(tmp.data_ptr()), p(y1.data_ptr()), p(z.data_ptr()),
        p(partial.data_ptr()), p(w1.data_ptr()), p(s1.data_ptr()),
        p(t1.data_ptr()), p(w2.data_ptr()), p(s2.data_ptr()),
        p(t2.data_ptr()), p(f1w.data_ptr()), p(f1b.data_ptr()),
        p(f2w.data_ptr()), p(f2b.data_ptr()), B, H, W, C, NB, hidden,
        p(torch.cuda.current_stream(x.device).cuda_stream))
    cuda_lib.check_launch(code, "se_stage kernel")
    launches += 1
    return out
