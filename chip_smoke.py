#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py             # the smoke run
    python3 chip_smoke.py --profile   # plus one profiled batch per precision
    python3 chip_smoke.py --out DIR   # where nvcc logs, the demo's npz and
                                      # result.json go (.runs/chip_smoke)

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. setup: the card's name and power limit, one nvcc per kernel source,
     all started together;
  2. each hand-written kernel against its plain PyTorch version on the card
     at the serving shapes, with its tolerance; kernel, plain and library
     times and the bound of the same work (2a attention, 2b mel, 2c the
     fused SE-ResNet stage at the audio encoder's stage-3 tail shape, B 1024,
     32 x 31, C 128, 5 blocks, in fp32 and bf16, with two faults planted in
     its operands that the check must fail); then kernel 3's path: the
     serving generator's layer3[0] output through
     `stage_params_from_module(layer3[1:])` + the kernel, against those
     blocks on cuDNN, in fp32 and bf16;
  3. the demo entry point (`emotiongestures_torch.cli.demo.main`) with the
     CUDA mel frontend, three diverse samples;
  4. the serving path at full width: batches of 1024 requests (a 4 s wave,
     a one-hot emotion, 60 word ids, 10 seed poses each) through the mel
     kernel, per-clip power_to_db, EmotionCVAEv3.sample and the flagship
     GestureTransformer (d_model 512, d_inner 2048, 3+3 layers, 8 heads,
     pose 282, 64 words) with fused attention, in fp32 and in bf16; the
     poses against the same forward on the plain attention path, the same
     comparison with two faults planted in the attention sublayer (it must
     fail them), and a small batch against the CPU. Weights are random,
     seeded in torch;
  5. the diversity-eval CLI through its `main` at full width on 2048
     synthetic samples in batches of 1024: `--preset fast` (bf16, fused
     attention, beat frontend on the card) with 2 diversity passes, and the
     fp32 parity preset with --skip_beat; finite metrics, 6 attention
     launches per eval_batch in the fast run, and in fp32 a 2-row eval_batch
     on the card against the CPU.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or without the
repository around it, the script fails before printing a result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from emotiongestures_torch.cli import demo  # noqa: E402
from emotiongestures_torch.cli import (  # noqa: E402
    test_emotion_gesture_diversity_iterative as eval_cli,
)
from emotiongestures_torch.core import precision as prec  # noqa: E402
from emotiongestures_torch.core.device import fp32_exact_on_cuda  # noqa: E402
from emotiongestures_torch.ops import cuda_lib  # noqa: E402
from emotiongestures_torch.ops import fused_attention as FA  # noqa: E402
from emotiongestures_torch.ops import fused_mel as FM  # noqa: E402
from emotiongestures_torch.ops import fused_se_stage as FS  # noqa: E402
from emotiongestures_torch.ops import mel as M  # noqa: E402
from emotiongestures_torch.data.synthetic import (  # noqa: E402
    SyntheticGestureDataset,
)
from emotiongestures_torch.nn import transformer as T  # noqa: E402
from emotiongestures_torch.nn.resnet_se import SEBasicBlock  # noqa: E402
from emotiongestures_torch.serving import (  # noqa: E402
    GestureServer,
    set_fused_attention,
)

# NVIDIA H100 SXM data sheet, dense: fp32 outside the tensor cores, bf16 on
# the tensor cores, HBM3
FP32_PEAK = 67e12
BF16_PEAK = 989e12
HBM_BYTES_PER_S = 3.35e12
BATCH = 1024
WAVE_SAMPLES = 64000  # 4 s at 16 kHz
N_BATCHES = 3
ATTN_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_pallas_attention.py
MEL_TOL = dict(rtol=2e-3, atol=1e-3)   # tests/test_pallas_mel.py
# serving poses, fused attention vs the plain attention path, same weights
# and noise: about ten times the largest reading on an H100 80GB HBM3 at
# 700 W in four runs (8.3e-7 in fp32, 5.2e-6 in bf16, where the plain
# path's products of the bf16 decoder query and bf16 weights round to bf16)
POSE_TOL = {"float32": dict(rtol=0.0, atol=1e-5),
            "bfloat16": dict(rtol=0.0, atol=5e-5)}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean ms per call on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_close(name, got, ref, rtol, atol) -> float:
    err = (got.float() - ref.float()).abs().max().item()
    ok = torch.allclose(got.float(), ref.float(), rtol=rtol, atol=atol)
    log(f"  {name}: max_abs_err {err:.3e} (rtol {rtol}, atol {atol}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


def bound(flops: float, nbytes: float, peak: float = FP32_PEAK):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_library(q_in, kv_in, wq, wk, wv, wo, s, b, n_head, d_k):
    """Yardstick only (never used by the port): the sublayer on cuBLAS
    projections, scaled_dot_product_attention and F.layer_norm, fp32."""
    F = torch.nn.functional
    f = torch.float32
    B, Lq, D = q_in.shape
    x, kv = q_in.to(f), kv_in.to(f)
    q = F.linear(x, wq.to(f)).view(B, Lq, n_head, d_k).transpose(1, 2)
    k = F.linear(kv, wk.to(f)).view(B, -1, n_head, d_k).transpose(1, 2)
    v = F.linear(kv, wv.to(f)).view(B, -1, n_head, d_k).transpose(1, 2)
    ctx = F.scaled_dot_product_attention(q, k, v)
    o = F.linear(ctx.transpose(1, 2).reshape(B, Lq, -1), wo.to(f)) + x
    return F.layer_norm(o, (D,), s.to(f), b.to(f), eps=1e-6)


def phase_attention(gen):
    log("phase 2a: fused attention kernel vs plain, B=1024, d_model 512")
    B, D, H, dk = BATCH, 512, 8, 64
    dev = torch.device("cuda")

    def make(Lq, Lk, q_dtype, w_dtype, self_attn):
        q = torch.randn(B, Lq, D, generator=gen, device=dev).to(q_dtype)
        kv = q if self_attn else torch.randn(B, Lk, D, generator=gen,
                                             device=dev)
        ws = [(torch.randn(D, D, generator=gen, device=dev) / D ** 0.5)
              .to(w_dtype) for _ in range(4)]
        s = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(w_dtype)
        b = (0.1 * torch.randn(D, generator=gen, device=dev)).to(w_dtype)
        return (q, kv, *ws, s, b)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = {
        # serving bf16: encoder self-attention, fp32 activations, bf16 weights
        "self 60x60 act fp32, w bf16": make(60, 60, f32, bf16, True),
        # serving bf16: decoder layer 0, bf16 query, fp32 keys, bf16 weights
        "cross 60x60 q bf16, kv fp32, w bf16": make(60, 60, bf16, bf16,
                                                    False),
        "self 60x60 fp32": make(60, 60, f32, f32, True),
        "cross 60x60 fp32": make(60, 60, f32, f32, False),
        "cross 60x37 fp32": make(60, 37, f32, f32, False),
    }
    errs, times = [], {}
    for name, args in cases.items():
        got = FA.fused_attention(*args, n_head=H, d_k=dk)
        ref = FA.fused_attention_plain(*args, n_head=H, d_k=dk)
        torch.cuda.synchronize()
        errs.append(check_close(name, got, ref, **ATTN_TOL))
        times[name] = (
            cuda_ms(lambda: FA.fused_attention(*args, n_head=H, d_k=dk)),
            cuda_ms(lambda: FA.fused_attention_plain(*args, n_head=H,
                                                     d_k=dk)),
            cuda_ms(lambda: attention_library(*args, n_head=H, d_k=dk)))
        log(f"    kernel {times[name][0]:.3f} ms, plain "
            f"{times[name][1]:.3f} ms, library {times[name][2]:.3f} ms")

    name = "self 60x60 act fp32, w bf16"
    q, kv, *w = cases[name]
    Lq = Lk = 60
    HD = H * dk
    flops = (2 * B * Lq * D * HD + 2 * 2 * B * Lk * D * HD
             + 2 * B * Lq * HD * D + 2 * 2 * B * H * Lq * Lk * dk)
    nbytes = (q.numel() * q.element_size()
              + sum(t.numel() * t.element_size() for t in w)
              + B * Lq * D * 4)
    b_ms, b_by = bound(flops, nbytes)
    k_ms, p_ms, l_ms = times[name]
    log(f"  timed case '{name}': {flops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e9:.3f} GB, bound {b_ms:.3f} ms ({b_by})")
    return {"name": "fused_attention", "route": "cuda",
            "source": "emotiongestures_torch/csrc/attention.cu",
            "replaces": "emotiongestures_tpu/ops/pallas_attention.py:35",
            "launches": 0, "max_abs_err": max(errs), "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms}, times


def mel_library(waves, fb_t):
    """Yardstick only: torch.stft (cuFFT) power spectrum @ filterbank."""
    win = torch.hann_window(M.N_FFT, periodic=True, device=waves.device)
    spec = torch.stft(waves, M.N_FFT, M.HOP, window=win, center=True,
                      pad_mode="reflect", return_complex=True)
    return (spec.abs() ** 2).transpose(1, 2) @ fb_t


def phase_mel(gen):
    log("phase 2b: mel kernel vs plain")
    dev = torch.device("cuda")
    fb_t = torch.from_numpy(M.mel_filterbank().T.astype("float32")).to(dev)
    entry, errs = None, []
    for clips, n in ((BATCH, WAVE_SAMPLES), (7, 25000)):
        waves = torch.randn(clips, n, generator=gen, device=dev)
        padded = M.pad_center(waves)
        nf = M.n_frames_of(padded.shape[-1])
        got = FM.mel_power(padded, nf)
        ref = FM.mel_power_plain(padded, nf)
        torch.cuda.synchronize()
        errs.append(check_close(f"{clips} clips x {nf} frames "
                                f"({clips * nf} frames)", got, ref,
                                **MEL_TOL))
        if entry is None:
            lib = mel_library(waves, fb_t)
            check_close("  library yardstick (torch.stft) vs plain", lib,
                        ref, **MEL_TOL)
            k_ms = cuda_ms(lambda: FM.mel_power(padded, nf))
            p_ms = cuda_ms(lambda: FM.mel_power_plain(padded, nf))
            l_ms = cuda_ms(lambda: mel_library(waves, fb_t))
            T = clips * nf
            bins = M.N_FFT // 2 + 1
            # the least work of the function, not of this kernel's design:
            # window, a real FFT (~2.5 N log2 N), |X|^2, and the filterbank
            # product over its nonzeros (each bin feeds at most two mels)
            fb_nnz = int(np.count_nonzero(M.mel_filterbank()))
            flops = T * (M.N_FFT + 2.5 * M.N_FFT * np.log2(M.N_FFT)
                         + 3 * bins + 2 * fb_nnz)
            consts = (M.N_FFT + fb_nnz) * 4
            nbytes = padded.numel() * 4 + T * M.N_MELS * 4 + consts
            b_ms, b_by = bound(flops, nbytes)
            # what this kernel does instead: the DFT as two dense GEMMs and a
            # dense filterbank GEMM, all fp32 FMA
            design = 2 * T * M.N_FFT * bins * 2 + 2 * T * bins * M.N_MELS
            log(f"    kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library "
                f"{l_ms:.3f} ms; least work {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e9:.3f} GB, bound {b_ms:.3f} ms ({b_by}); the "
                f"kernel's DFT-as-GEMM does {design / 1e9:.1f} GFLOP, "
                f"{design / FP32_PEAK * 1e3:.3f} ms at the fp32 peak")
            entry = {"name": "mel", "route": "cuda",
                     "source": "emotiongestures_torch/csrc/mel.cu",
                     "replaces": "emotiongestures_tpu/ops/pallas_mel.py:52",
                     "launches": 0, "max_abs_err": 0.0, "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": l_ms}
    entry["max_abs_err"] = max(errs)
    return entry


SE_SHAPE = (BATCH, 32, 31, 128, 5)  # B, H, W, C, blocks: layer3[1:]


def se_tol(precision, ref):
    """Kernel 3 against its plain version. fp32: the tolerance of
    tests/test_pallas_se.py. bf16: both round bn1's output, the SE fc inputs
    and each block's output to bf16, and sums in another order can flip a
    rounding that the next blocks carry on, so the limit is 8 bf16 steps
    (2^-8 each) of max |ref|, rtol 0: about 3x the largest reading (0.125,
    two ulps at max |ref| 12.8, on an H100 80GB HBM3 at 700 W)."""
    if precision == "float32":
        return dict(rtol=2e-5, atol=2e-5)
    return dict(rtol=0.0, atol=8 * 2.0 ** -8 * ref.float().abs().max().item())


def se_path_tol(precision, ref):
    """Kernel 3 against the serving generator's own blocks on cuDNN. fp32
    (TF32 off): cuDNN picks other algorithms (FFT, Winograd) and sums in
    another order, rtol 1e-4 / atol 1e-4 (reading 1.26e-4 at max |ref| 67.3
    on an H100 80GB HBM3 at 700 W, where the limit is 6.8e-3). bf16: the
    blocks round each conv output, BatchNorm output, SE product and residual
    sum to bf16 where the kernel keeps fp32, so the limit is 2^-5 of
    max |ref|, rtol 0: about 2.7x the reading (0.75 at max |ref| 66)."""
    if precision == "float32":
        return dict(rtol=1e-4, atol=1e-4)
    return dict(rtol=0.0, atol=2.0 ** -5 * ref.float().abs().max().item())


def se_blocks(seed):
    """Five stride-1 SEBasicBlock(128, 128) on the card, eval mode, with
    BatchNorm affines and statistics moved off their init."""
    torch.manual_seed(seed)
    g = torch.Generator().manual_seed(seed)
    blocks = torch.nn.Sequential(*[SEBasicBlock(128, 128)
                                   for _ in range(SE_SHAPE[4])])
    with torch.no_grad():
        for m in blocks.modules():
            if hasattr(m, "running_var"):
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.normal_(1.0, 0.2, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    return blocks.cuda().eval()


def se_library(blocks, x_nhwc):
    """Yardstick only (never used by the port): the port's SEBasicBlock
    stack on cuDNN, the NHWC activations viewed as NCHW (channels-last)."""
    with torch.no_grad():
        return blocks(x_nhwc.permute(0, 3, 1, 2))


def se_faults(ops):
    """Operands with a planted fault: one tap of the last block's w1
    zeroed; the last block's SE gate saturated (f2b + 30)."""
    w1 = ops[0].clone()
    w1[-1, 0, 0] = 0
    f2b = ops[9].clone()
    f2b[-1] += 30.0
    return {"w1 tap zeroed": (w1,) + ops[1:],
            "SE gate saturated": ops[:9] + (f2b,)}


def phase_se_stage(gen):
    B, H, W, C, NB = SE_SHAPE
    log(f"phase 2c: SE-stage kernel vs plain, B={B}, {H}x{W}, C={C}, "
        f"{NB} blocks")
    blocks = se_blocks(0)
    ops = FS.stage_params_from_module(list(blocks))
    x = torch.relu(torch.randn(B, H, W, C, generator=gen, device="cuda"))
    lib_blocks = {"float32": blocks,
                  "bfloat16": prec.bf16_params_(se_blocks(0))}
    entry, detail, errs = None, {}, []
    for precision, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
        xd = x.to(dt)
        got = FS.fused_se_stage(xd, *ops)
        ref = FS.fused_se_stage_plain(xd, *ops)
        torch.cuda.synchronize()
        tol = se_tol(precision, ref)
        errs.append(check_close(f"{precision}, max |ref| "
                                f"{ref.float().abs().max().item():.3f}",
                                got, ref, **tol))
        for fault, bad_ops in se_faults(ops).items():
            bad = FS.fused_se_stage(xd, *bad_ops)
            err = (bad.float() - ref.float()).abs().max().item()
            caught = not torch.allclose(bad.float(), ref.float(), **tol)
            log(f"    planted fault {fault}: max_abs_err {err:.3e}, "
                f"{'caught' if caught else 'MISSED'}")
            if not caught:
                raise SystemExit(f"the SE-stage check misses {fault}")
        lib = lib_blocks[precision]
        k_ms = cuda_ms(lambda: FS.fused_se_stage(xd, *ops), iters=3)
        p_ms = cuda_ms(lambda: FS.fused_se_stage_plain(xd, *ops), iters=3)
        l_ms = cuda_ms(lambda: se_library(lib, xd), iters=3)
        convs = NB * 2 * (2 * B * H * W * 9 * C * C)
        hidden = ops[6].shape[-1]
        flops = convs + NB * B * 2 * (2 * C * hidden)
        nbytes = (2 * xd.numel() * xd.element_size()
                  + sum(t.numel() * (xd.element_size() if t.ndim == 5
                                     or i in (6, 8) else 4)
                        for i, t in enumerate(ops)))
        peak = FP32_PEAK if precision == "float32" else BF16_PEAK
        b_ms, b_by = bound(flops, nbytes, peak)
        log(f"    kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library "
            f"(SEBasicBlocks on cuDNN) {l_ms:.3f} ms; {flops / 1e9:.1f} "
            f"GFLOP, {nbytes / 1e9:.3f} GB, bound {b_ms:.3f} ms ({b_by}, "
            f"{peak / 1e12:.0f} TFLOP/s)")
        detail[precision] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "max_abs_err": errs[-1]}
        if entry is None:
            entry = {"name": "se_stage", "route": "cuda",
                     "source": "emotiongestures_torch/csrc/se_stage.cu",
                     "replaces":
                         "emotiongestures_tpu/ops/pallas_se_block.py:42",
                     "launches": 0, "max_abs_err": 0.0, "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": l_ms}
    # the entry's numbers are the fp32 stage's; "bf16" holds the bf16 ones
    entry["max_abs_err"] = errs[0]
    entry["bf16"] = detail["bfloat16"]
    return entry, detail


def phase_se_path(precision, gen, counts):
    """The kernel's path: the serving generator's stage-3 tail."""
    log(f"phase 2c ({precision}): the serving generator's layer3[0] output "
        f"through the kernel vs layer3[1:] on cuDNN")
    dev = torch.device("cuda")
    server = GestureServer(fused_attention=True, precision=precision,
                           device="cuda", seed=0)
    fe = server.gen.audio_encoder.feat_extractor
    waves = requests(gen, BATCH, dev)[0]
    with torch.no_grad():
        spec = server.spectrogram(waves).to(server.dtype)
        x = fe.bn1(torch.relu(fe.conv1(spec[:, None])))
        x = fe.layer3[0](fe.layer2(fe.layer1(x)))
        ops = FS.stage_params_from_module(list(fe.layer3[1:]))
        x_nhwc = x.permute(0, 2, 3, 1).contiguous()
        torch.cuda.synchronize()
        reset_counts()
        got = FS.fused_se_stage(x_nhwc, *ops)
        n = FS.launches
        ref = fe.layer3[1:](x).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
    counts["se_stage"] += n
    if n != 1 or tuple(got.shape) != (BATCH, 32, 31, 128):
        raise SystemExit(f"{precision}: SE-stage launches {n}, out "
                         f"{tuple(got.shape)}")
    check_close(f"{precision} kernel vs layer3[1:], max |ref| "
                f"{ref.float().abs().max().item():.3f}", got, ref,
                **se_path_tol(precision, ref))


# ---------------------------------------------------------------------------
# phases 3, 4 and 5: the entry points
# ---------------------------------------------------------------------------

def reset_counts():
    FA.launches = 0
    FM.launches = 0
    FS.launches = 0


def phase_demo(out_dir: Path):
    log("phase 3: demo entry point, --frontend pallas --num_samples 3")
    args = demo.build_parser().parse_args([
        "--frontend", "pallas", "--num_samples", "3", "--device", "cuda",
        "--out", str(out_dir / "demo")])
    reset_counts()
    summary = demo.main(args)
    mel_launches = FM.launches
    poses = np.load(summary["out"])["poses"]
    if poses.shape != (3, 60, 282) or not np.isfinite(poses).all():
        raise SystemExit(f"demo: bad poses {poses.shape}")
    if mel_launches < 1:
        raise SystemExit("demo: the mel kernel was not launched")
    log(f"  poses {poses.shape} finite; mel launches {mel_launches}; "
        f"pairwise distance {summary['pairwise_sample_distance']}")


def requests(gen, n, dev):
    waves = 0.3 * torch.randn(n, WAVE_SAMPLES, generator=gen, device=dev)
    y = torch.nn.functional.one_hot(torch.arange(n, device=dev) % 8,
                                    8).float()
    text = torch.randint(0, 64, (n, 60), generator=gen, device=dev)
    prior = torch.randn(n, 10, 282, generator=gen, device=dev)
    noise = torch.randn(n, 32, generator=gen, device=dev)
    return waves, y, text, prior, noise


KERNEL_GROUPS = (  # (group, substrings of a CUDA kernel's name), in order
    ("attention kernel (csrc/attention.cu)", ("mha_heads", "mha_out_ln")),
    ("mel kernel (csrc/mel.cu)", ("mel_kernel",)),
    ("convolution (cuDNN)", ("fprop", "conv", "cudnn", "dgrad", "wgrad")),
    ("matmul (cuBLAS/CUTLASS)", ("gemm", "cutlass", "matmul")),
    ("elementwise and reductions", ("elementwise", "reduce", "softmax",
                                    "cat", "copy", "fill", "index")),
)


def profile_batch(server, inputs, precision, card):
    """With --profile: one batch under torch.profiler, CUDA kernel time by
    group and the device's busy share of the batch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.generate(*inputs[:4], noise=inputs[4])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        name = evt.key
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        top.append((us / 1e3, evt.count, name[:90]))
    busy = sum(groups.values())
    log(f"  profile ({precision}, [{card}]): wall {wall_ms:.1f} ms (under "
        f"the profiler), CUDA kernels {busy:.1f} ms, device busy share "
        f"{busy / wall_ms:.3f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:9.2f} ms  {100 * ms / busy:5.1f}%  {g}")
    for ms, n, name in sorted(top, reverse=True)[:12]:
        log(f"      {ms:8.2f} ms  x{n:<4d} {name}")
    return {"precision": precision, "wall_ms": wall_ms, "kernel_ms": busy,
            "groups_ms": groups}


def drop_last_head(q_in, kv_in, wq, wk, wv, wo, *rest, n_head, d_k):
    wo = wo.clone()
    wo[:, (n_head - 1) * d_k:] = 0  # the last head adds nothing
    return FA.fused_attention(q_in, kv_in, wq, wk, wv, wo, *rest,
                              n_head=n_head, d_k=d_k)


def mask_last_key(q_in, kv_in, *rest, n_head, d_k):
    # the mask one key too short: Lk - 1 keys
    return FA.fused_attention(q_in, kv_in[:, :-1].contiguous(), *rest,
                              n_head=n_head, d_k=d_k)


def planted_faults(server, inputs, plain, tol):
    """The fused-vs-plain pose check must fail a faulty kernel: run the
    forward with each fault planted in every attention sublayer (the real
    kernel on altered operands) and require the check to reject it."""
    for fault in (drop_last_head, mask_last_key):
        T.fused_attention = fault
        try:
            bad = server.forward_spec(*inputs[:4], noise=inputs[4])[0]
        finally:
            T.fused_attention = FA.fused_attention
        err = (bad - plain).abs().max().item()
        caught = not torch.allclose(bad, plain, **tol)
        log(f"  planted fault {fault.__name__}: max_abs_err {err:.3e}, "
            f"{'caught' if caught else 'MISSED'}")
        if not caught:
            raise SystemExit(f"the pose check misses {fault.__name__}")


def phase_serving(precision, gen, card, counts, profiling=False):
    log(f"phase 4 ({precision}): serving, batches of {BATCH} requests")
    dev = torch.device("cuda")
    server = GestureServer(fused_attention=True, precision=precision,
                           device="cuda", seed=0)
    waves, y, text, prior, noise = requests(gen, BATCH, dev)
    server.generate(waves, y, text, prior, noise=noise)  # warm-up
    torch.cuda.synchronize()

    # the main path, counted: mel kernel -> CVAE prior -> generator
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(N_BATCHES):
        outs = server.generate(waves, y, text, prior, noise=noise)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / N_BATCHES
    n_attn, n_mel = FA.launches, FM.launches
    counts["fused_attention"] += n_attn
    counts["mel"] += n_mel
    if n_attn != 6 * N_BATCHES or n_mel != N_BATCHES:
        raise SystemExit(f"{precision}: attention launches {n_attn} (want "
                         f"{6 * N_BATCHES}), mel launches {n_mel} (want "
                         f"{N_BATCHES})")
    poses = outs[0]
    if poses.shape != (BATCH, 60, 282) or poses.dtype != torch.float32 \
            or not torch.isfinite(poses).all():
        raise SystemExit(f"{precision}: bad poses {poses.shape} "
                         f"{poses.dtype}")
    spec = server.spectrogram(waves)
    t_mel = cuda_ms(lambda: server.spectrogram(waves), iters=3)
    t_fwd = cuda_ms(lambda: server.forward_spec(spec, y, text, prior,
                                                noise=noise), iters=3)
    log(f"  [{card}] {dt * 1e3:.1f} ms per batch of {BATCH}, "
        f"{BATCH * 60 / dt:.0f} frames/s; of which log-mel {t_mel:.2f} ms, "
        f"CVAE+generator {t_fwd:.1f} ms; attention launches {n_attn}, "
        f"mel launches {n_mel} over {N_BATCHES} batches")

    # the same forward on the plain attention path, same weights and noise
    ref = server.forward_spec(spec, y, text, prior, noise=noise)[0]
    set_fused_attention(server.gen, False)
    plain = server.forward_spec(spec, y, text, prior, noise=noise)[0]
    set_fused_attention(server.gen, True)
    tol = POSE_TOL[precision]
    check_close("poses fused vs plain path", ref, plain, **tol)
    planted_faults(server, (spec, y, text, prior, noise), plain, tol)

    if precision == "float32":
        # a small batch on the card against the CPU (plain mel, plain
        # attention, CPU convolutions), same weights
        cpu = GestureServer(fused_attention=True, precision=precision,
                            device="cpu", seed=1)
        cpu.gen.load_state_dict({k: v.cpu() for k, v in
                                 server.gen.state_dict().items()})
        cpu.vae.load_state_dict({k: v.cpu() for k, v in
                                 server.vae.state_dict().items()})
        small = [t[:2] for t in (waves, y, text, prior, noise)]
        on_card = server.generate(*small[:4], noise=small[4])[0]
        on_cpu = cpu.generate(*[t.cpu() for t in small[:4]],
                              noise=small[4].cpu())[0]
        check_close("2 requests, card vs CPU", on_card.cpu(), on_cpu,
                    rtol=2e-3, atol=5e-4)
    result = {"precision": precision, "ms_per_batch": dt * 1e3,
              "frames_per_s": BATCH * 60 / dt, "log_mel_ms": t_mel,
              "cvae_generator_ms": t_fwd, "batch": BATCH, "card": card}
    if profiling:
        result["profile"] = profile_batch(
            server, (waves, y, text, prior, noise), precision, card)
    return result


EVAL_SAMPLES = 2048
EVAL_RUNS = {  # name: extra flags
    "fast": ["--preset", "fast", "--num_diversity_passes", "2"],
    "fp32": ["--skip_beat"],
}
METRICS = ("l2", "mpjre_deg", "fgd", "beat", "emotion_acc", "diversity")


def eval_card_vs_cpu(args):
    """A 2-row eval_batch on the card against the CPU: same weights (the
    card's, copied), same batch, same z."""
    nets = eval_cli.build_models(args, eval_cli.N_WORDS_SYNTHETIC, "cuda")
    cpu = eval_cli.build_models(args, eval_cli.N_WORDS_SYNTHETIC, "cpu")
    for name in ("gen", "fgd", "skeleton", "vae"):
        getattr(cpu, name).load_state_dict(
            {k: v.cpu() for k, v in getattr(nets, name).state_dict().items()})
    batch = next(SyntheticGestureDataset(n_samples=2, seed=1).batches(
        2, shuffle=False, fields=("spectrogram", "text", "pose_seq",
                                  "eid_label")))
    inputs = [torch.from_numpy(batch[k]) for k in ("spectrogram", "text",
                                                   "pose_seq", "eid_label")]
    z = torch.randn(2, 32, generator=torch.Generator().manual_seed(2))
    on_card = eval_cli.eval_batch(nets, *[t.cuda() for t in inputs],
                                  noise=z.cuda())
    on_cpu = eval_cli.eval_batch(cpu, *inputs, noise=z)
    names = ("poses", "skeleton logits", "FGD features (poses)",
             "FGD features (target)", "rotation error")
    for name, a, b in zip(names, on_card, on_cpu):
        check_close(f"2 rows, card vs CPU, {name}", a.cpu(), b, rtol=2e-3,
                    atol=5e-4)


def phase_eval(card, counts, out_dir: Path):
    results = {}
    for name, extra in EVAL_RUNS.items():
        log(f"phase 5 ({name}): eval CLI main, --synthetic {EVAL_SAMPLES} "
            f"--test_batch_size {BATCH} {' '.join(extra)}")
        args = eval_cli.build_parser().parse_args([
            "--synthetic", str(EVAL_SAMPLES), "--test_batch_size",
            str(BATCH), "--device", "cuda", "--log_save_path",
            str(out_dir / "eval_logs"), *extra])
        reset_counts()
        summary = eval_cli.main(args)
        n_attn = FA.launches
        timings = summary["timings"]
        calls = timings["eval_batch_calls"]
        bad = [k for k in METRICS if not np.isfinite(summary[k])]
        if bad:
            raise SystemExit(f"eval {name}: non-finite metrics {bad}")
        want_calls = (EVAL_SAMPLES // BATCH) * max(
            args.num_diversity_passes, 1)
        want_attn = 6 * calls if args.fused_attention else 0
        if calls != want_calls or n_attn != want_attn:
            raise SystemExit(f"eval {name}: {calls} eval_batch calls (want "
                             f"{want_calls}), attention launches {n_attn} "
                             f"(want {want_attn})")
        counts["fused_attention"] += n_attn
        ms = timings["eval_batch_ms"]
        host_s = (timings["data_wait_s"] + timings["beat_s"]
                  + timings["frechet_diversity_s"])
        log(f"  [{card}] {name}: " + ", ".join(
            f"{k} {summary[k]:.5f}" for k in METRICS))
        log(f"  [{card}] {name}: eval_batch {np.mean(ms[1:] or ms):.1f} ms "
            f"per call of {BATCH} rows (device, CUDA events; mean of calls "
            f"2-{calls}; all: {', '.join(f'{t:.1f}' for t in ms)}); "
            f"attention launches {n_attn} = 6 x {calls}; eval wall "
            f"{timings['wall_s']:.2f} s, of which waiting for batches "
            f"(host data) {timings['data_wait_s']:.2f} s, host beat "
            f"alignment {timings['beat_s']:.2f} s and Frechet + diversity "
            f"{timings['frechet_diversity_s']:.2f} s (host share "
            f"{host_s / timings['wall_s']:.3f})")
        if name == "fp32":
            eval_card_vs_cpu(args)
        results[name] = {k: summary[k] for k in METRICS}
        results[name]["timings"] = timings
    return results


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--profile", action="store_true",
                        help="add one profiled batch per precision")
    parser.add_argument("--out", type=Path,
                        default=REPO / ".runs" / "chip_smoke")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    fp32_exact_on_cuda()
    log("TF32 off in cuDNN and cuBLAS: fp32 convolutions and matmuls in "
        "full fp32 for the checks and the fp32 serving run")
    args.out.mkdir(parents=True, exist_ok=True)

    log("phase 1: build")
    t0 = time.perf_counter()
    cuda_lib.build_all()
    log(f"  nvcc, {len(cuda_lib.SOURCES)} sources in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in cuda_lib.build_logs.items():
        (args.out / f"nvcc_{name}.log").write_text(text)

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_entry, attn_times = phase_attention(gen)
    mel_entry = phase_mel(gen)
    # kernel 3 draws from its own generator, so the later phases see the
    # same inputs as before it was added
    se_gen = torch.Generator(device="cuda").manual_seed(3)
    se_entry, se_detail = phase_se_stage(se_gen)
    counts = {"fused_attention": 0, "mel": 0, "se_stage": 0}
    for precision in ("float32", "bfloat16"):
        phase_se_path(precision, se_gen, counts)
    phase_demo(args.out)
    serving = [phase_serving(p, gen, card, counts, args.profile)
               for p in ("float32", "bfloat16")]
    evals = phase_eval(card, counts, args.out)
    entries = (attn_entry, mel_entry, se_entry)
    for e in entries:
        e["launches"] = counts[e["name"]]
        if e["launches"] < 1:
            raise SystemExit(f"{e['name']}: not launched on the main path")

    detail = {"card": card, "serving": serving, "eval": evals,
              "se_stage": se_detail,
              "attention_cases_ms": {k: {"kernel": v[0], "plain": v[1],
                                         "library": v[2]}
                                     for k, v in attn_times.items()}}
    (args.out / "result.json").write_text(json.dumps(detail, indent=1))
    log(json.dumps({"serving": serving}))
    log(card)
    log(json.dumps({"kernels": list(entries)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
