"""Fused SE-ResNet stage: the CUDA kernels of `csrc/se_stage.cu` and their
plain PyTorch version.

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
a CUDA tensor launches a kernel or raises. bf16 runs the whole stage in one
launch, as the TPU kernel does: a thread-block cluster of n <= 8 CTAs per
sample (`cluster_layout`) keeps the sample's activations in shared memory
across every block, with the convs on wgmma fed by TMA-multicast weight
tiles (repacked K-major by `pack_weights`), so device memory sees only x and
the output; it is bound by the tensor cores. fp32 takes 3 launches per block
through device memory (fp32 FMA convs; a sample's fp32 activations would need
a cluster of 16). `launches` counts the calls that went to a kernel.
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
TILE_PIXELS = 128        # output pixels per fp32 conv block (kBM)
MAX_HIDDEN = 64
MAX_CLUSTER = 8          # CTAs per sample in the bf16 kernel (kMaxCluster)
# the bf16 kernel's shared memory per CTA besides its two activation tiles
# and SE fc weights: csrc/se_stage.cu's kBaseSmem (alignment slack, pool
# sums, hidden, gate, affines, mbarriers) and its ring of 4 weight tiles of
# 128 x 64 bf16. The kernel refuses a launch given less than its carve-up
# (`cluster_smem` there), so a stale copy here fails loudly on the card.
SMEM_FIXED = (1024 + 8 * 128 * 4 + 3 * 128 * 4 + 64 * 4 + 4 * 128 * 4
              + 2 * 4 * 8 + 16 + 4 * 128 * 64 * 2)
SMEM_LIMIT = 232448      # the most shared memory an H100 CTA may have


def cluster_smem(R: int, W: int, hidden: int = KERNEL_CHANNELS // 8):
    """Bytes of shared memory per CTA of the bf16 kernel at R rows of W
    pixels: two (R+2) x (W+2) x 128 bf16 tiles, the block's SE fc weights
    (2 x 128 x hidden bf16) and `SMEM_FIXED`."""
    return (SMEM_FIXED + 2 * (R + 2) * (W + 2) * KERNEL_CHANNELS * 2
            + 4 * KERNEL_CHANNELS * hidden)


def cluster_layout(H: int, W: int, hidden: int = KERNEL_CHANNELS // 8):
    """The bf16 kernel's split of one H x W sample over a thread-block
    cluster: (R, n), R whole image rows per CTA (R * W <= 128 GEMM rows)
    and n CTAs. This is the one place the layout is chosen; the kernel only
    checks it. Raises ValueError for a shape the kernel does not take."""
    if not 1 <= W <= KERNEL_CHANNELS or H < 1:
        raise ValueError(f"fused_se_stage: the bf16 kernel takes 1 <= W <= "
                         f"{KERNEL_CHANNELS}; got H {H}, W {W}")
    R = min(H, KERNEL_CHANNELS // W)
    n = -(-H // R)
    if n > MAX_CLUSTER:
        raise ValueError(
            f"fused_se_stage: the bf16 kernel takes H <= {MAX_CLUSTER} * "
            f"(128 // W) rows (a cluster of at most {MAX_CLUSTER} CTAs); got "
            f"H {H}, W {W}: {n} CTAs of {R} rows")
    smem = cluster_smem(R, W, hidden)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fused_se_stage: the bf16 kernel's two ({R}+2) x ({W}+2) x 128 "
            f"tiles need {smem} bytes of shared memory per CTA, more than "
            f"{SMEM_LIMIT}; got H {H}, W {W}, hidden {hidden}")
    return R, n


def pack_weights(w1, w2):
    """The bf16 kernel's weight tensor: (NB, 2, 9, C_out, C_in), conv c's
    tap k as a K-major (output, input channel) matrix, from HWIO w1, w2
    (NB, 3, 3, C_in, C_out); contiguous, in w1's dtype and device."""
    NB, _, _, ci, co = w1.shape
    return (torch.stack([w1, w2], dim=1).permute(0, 1, 2, 3, 5, 4)
            .reshape(NB, 2, 9, co, ci).contiguous())


def unpack_weights(wk):
    """`pack_weights`'s inverse: (w1, w2), each (NB, 3, 3, C_in, C_out)."""
    NB, _, _, co, ci = wk.shape
    w = wk.reshape(NB, 2, 3, 3, co, ci).permute(0, 1, 2, 3, 5, 4)
    return w[:, 0].contiguous(), w[:, 1].contiguous()


def active_clusters(H: int, W: int, hidden: int = KERNEL_CHANNELS // 8):
    """How many of the bf16 kernel's clusters at (H, W) the card holds at
    once (cudaOccupancyMaxActiveClusters); needs the card."""
    R, n = cluster_layout(H, W, hidden)
    count = cuda_lib.load("se_stage").eg_se_active_clusters(
        n, cluster_smem(R, W, hidden))
    if count < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with "
                           f"cudaError_t {-count}")
    return count


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
    x's dtype. On the card x must be contiguous with C == 128, and a bf16
    x's H x W must fit `cluster_layout`."""
    global launches
    if x.device.type == "cpu":
        return fused_se_stage_plain(x, w1, s1, t1, w2, s2, t2, f1w, f1b,
                                    f2w, f2b)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_se_stage: no kernel for {x.device}")
    tensors = _operands(x, w1, s1, t1, w2, s2, t2, f1w, f1b, f2w, f2b)
    B, H, W, C, NB, hidden = _check(x, w1, f1w, tensors)
    (w1, w2, f1w, f2w), (s1, t1, s2, t2, f1b, f2b) = tensors
    if x.dtype == torch.bfloat16:
        R, n = cluster_layout(H, W, hidden)
    lib = cuda_lib.load("se_stage")
    p = ctypes.c_void_p
    out = torch.empty_like(x)
    stream = p(torch.cuda.current_stream(x.device).cuda_stream)
    if x.dtype == torch.bfloat16:
        wk = pack_weights(w1, w2)
        code = lib.eg_se_stage_bf16(
            p(x.data_ptr()), p(out.data_ptr()), p(wk.data_ptr()),
            *[p(t.data_ptr()) for t in (s1, t1, s2, t2, f1w, f1b, f2w,
                                        f2b)], B, H, W, R, n, NB, hidden,
            cluster_smem(R, W, hidden), stream)
    else:
        tiles = -(-H * W // TILE_PIXELS)
        tmp = torch.empty_like(x) if NB > 1 else out
        y1 = torch.empty_like(x)
        z = torch.empty_like(x)
        partial = torch.empty(B, tiles, C, dtype=torch.float32,
                              device=x.device)
        code = lib.eg_se_stage_fp32(
            *[p(t.data_ptr()) for t in (x, out, tmp, y1, z, partial, w1, s1,
                                        t1, w2, s2, t2, f1w, f1b, f2w,
                                        f2b)], B, H, W, NB, hidden, stream)
    cuda_lib.check_launch(code, "se_stage kernel")
    launches += 1
    return out
