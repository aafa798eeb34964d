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
     times and the bound of the same work (2a attention in five cases, with
     the least time of its fp32-accurate products on the tensor cores
     beside that of plain fp32 FMA, and two precision faults planted in its
     operands that the check must fail: fp32 weights rounded to TF32, fp32
     activations rounded to TF32; 2b mel, the FFT kernel, with two faults
     planted in its operands that the check must fail; 2c the fused
     SE-ResNet stage at the audio encoder's stage-3 tail shape, B 1024,
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
     on the card against the CPU;
  6. GAN training through the trainer's `main` at full width (d_model 512,
     d_inner 2048, 3+3 layers, 8 heads, pose 282, 60 frames, 64 words,
     batch 128) on 512 synthetic samples: 6a `--preset parity` (fp32,
     d_first), 2 epochs (8 steps), then `--resume` for one more epoch, which
     must end at step 12 for G and D; 6b `--preset fast` (bf16 compute,
     g_first), the same. ms per step (CUDA events, steps 3-8), samples/s,
     peak memory and the last losses, which must be finite; no kernel
     launch during training (the attention kernel fuses only in eval mode).
     6c: one d_first train_step at d_model 128, one layer, batch 8, dropout
     off, on the card and on the CPU from the same weights and batch;
     losses, Adam moments, BatchNorm running statistics and parameters
     compared, and the same comparison with a fault planted on the card
     (torch's momentum convention in the running update) that it must
     fail.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or without the
repository around it, the script fails before printing a result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
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
from emotiongestures_torch.cli import (  # noqa: E402
    train_emotion_gesture as train_cli,
)
from emotiongestures_torch.core import layers as L  # noqa: E402
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
from emotiongestures_torch.train import gan  # noqa: E402

# NVIDIA H100 SXM data sheet, dense: fp32 outside the tensor cores, TF32 and
# bf16 on the tensor cores, HBM3
FP32_PEAK = 67e12
TF32_PEAK = 495e12
BF16_PEAK = 989e12
HBM_BYTES_PER_S = 3.35e12
BATCH = 1024
WAVE_SAMPLES = 64000  # 4 s at 16 kHz
N_BATCHES = 3
ATTN_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_pallas_attention.py
MEL_TOL = dict(rtol=2e-3, atol=1e-3)   # tests/test_pallas_mel.py
MEL_TILE = 8  # frames per block of the mel kernel (csrc/mel.cu kTile)
# serving poses, fused attention vs the plain attention path, same weights
# and noise: about ten times the largest reading of the fp32-FMA attention
# kernel on an H100 80GB HBM3 at 700 W in four runs (8.3e-7 in fp32, 5.2e-6
# in bf16, where the plain path's products of the bf16 decoder query and
# bf16 weights round to bf16); the tensor-core kernel's readings are in
# PERF.md section 6
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


def tf32_round(x):
    """fp32 -> the nearest TF32 value (ties away from zero), as fp32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def exact_ms(flops: float, n_fp32: int) -> float:
    """Least ms on the tensor cores for `flops` of products with `n_fp32`
    (0, 1 or 2) fp32 operands at fp32 accuracy: a fp32 operand is three
    bf16 terms or two TF32 terms, a bf16 one a single term of either, so a
    product takes 1, 3 or 6 bf16 passes at 989 TFLOP/s, or 1, 2 or 3 TF32
    passes at 495, whichever is less."""
    return flops * min((1, 3, 6)[n_fp32] / BF16_PEAK,
                       (1, 2, 3)[n_fp32] / TF32_PEAK) * 1e3


def attention_work(q, kv, w, n_head, d_k):
    """The sublayer's work at these inputs: FLOP, bytes (each input read
    once, the output written once) and the bound: max(the least time of its
    products on the tensor cores at fp32 accuracy (`exact_ms`; the context
    and the core's Q, K, V and P are fp32), bytes / 3.35 TB/s). Beside it,
    for the log and result.json: the same work in plain fp32 FMA at 67
    TFLOP/s, and the TF32 FLOP of this kernel's own recipe
    (csrc/attention.cu: a fp32 operand costs a second pass, a second fp32
    operand a third; the core is 3xTF32) at 495 TFLOP/s."""
    B, Lq, D = q.shape
    Lk = kv.shape[1]
    HD = n_head * d_k
    self_attn = kv.data_ptr() == q.data_ptr()
    fp32 = lambda t: int(t.dtype == torch.float32)
    n_q, n_kv, n_w = fp32(q), fp32(kv), fp32(w[0])

    proj_q = 2 * B * Lq * D * HD
    proj_kv = 2 * 2 * B * Lk * D * HD
    proj_o = 2 * B * Lq * HD * D  # over the fp32 context
    core = 2 * 2 * B * n_head * Lq * Lk * d_k
    flops = proj_q + proj_kv + proj_o + core
    tc_ms = (exact_ms(proj_q, n_q + n_w) + exact_ms(proj_kv, n_kv + n_w)
             + exact_ms(proj_o, 1 + n_w) + exact_ms(core, 2))
    nbytes = (q.numel() * q.element_size()
              + (0 if self_attn else kv.numel() * kv.element_size())
              + sum(t.numel() * t.element_size() for t in w)
              + B * Lq * D * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    design = (proj_q * (1 + n_q + n_w) + proj_kv * (1 + n_kv + n_w)
              + proj_o * (2 + n_w) + 3 * core)
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(tc_ms, bytes_ms),
            "bound_by": "operations" if tc_ms >= bytes_ms else "bytes",
            "bound_fp32_fma_ms": bound(flops, nbytes)[0],
            "design_tf32_flops": design,
            "design_tf32_ms": design / TF32_PEAK * 1e3}


def precision_faults(cases):
    """Operands with a planted precision fault, each compared with the plain
    version on the unrounded operands: the four weights rounded to TF32 in
    fp32 self-attention (a kernel that took fp32 weights as TF32), and the
    activations rounded to TF32 in the timed case (one that split nothing)."""
    q, kv, *w = cases["self 60x60 fp32"]
    bad_w = [tf32_round(t) for t in w[:4]] + w[4:]
    faults = {"self 60x60 fp32, weights rounded to TF32":
              ("self 60x60 fp32", (q, kv, *bad_w))}
    q, kv, *w = cases["self 60x60 act fp32, w bf16"]
    bad_q = tf32_round(q)
    faults["self 60x60 act fp32, w bf16, activations rounded to TF32"] = (
        "self 60x60 act fp32, w bf16", (bad_q, bad_q, *w))
    return faults


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
    errs, times, refs = [], {}, {}
    for name, args in cases.items():
        got = FA.fused_attention(*args, n_head=H, d_k=dk)
        ref = FA.fused_attention_plain(*args, n_head=H, d_k=dk)
        torch.cuda.synchronize()
        errs.append(check_close(name, got, ref, **ATTN_TOL))
        refs[name] = ref
        work = attention_work(args[0], args[1], args[2:], H, dk)
        times[name] = {
            "kernel": cuda_ms(lambda: FA.fused_attention(*args, n_head=H,
                                                         d_k=dk)),
            "plain": cuda_ms(lambda: FA.fused_attention_plain(
                *args, n_head=H, d_k=dk)),
            "library": cuda_ms(lambda: attention_library(*args, n_head=H,
                                                         d_k=dk)),
            "max_abs_err": errs[-1], **work}
        t = times[name]
        log(f"    kernel {t['kernel']:.3f} ms, plain {t['plain']:.3f} ms, "
            f"library {t['library']:.3f} ms; {work['flops'] / 1e9:.1f} "
            f"GFLOP, {work['bytes'] / 1e9:.3f} GB; bound "
            f"{work['bound_ms']:.3f} ms ({work['bound_by']}, fp32-accurate "
            f"products on the tensor cores), in plain fp32 FMA "
            f"{work['bound_fp32_fma_ms']:.3f} ms; this kernel's TF32 passes "
            f"{work['design_tf32_flops'] / 1e9:.1f} GFLOP, "
            f"{work['design_tf32_ms']:.3f} ms at 495 TFLOP/s")
    faults = {}
    for fault, (base, args) in precision_faults(cases).items():
        bad = FA.fused_attention(*args, n_head=H, d_k=dk)
        ref = refs[base]
        err = (bad - ref).abs().max().item()
        caught = not torch.allclose(bad, ref, **ATTN_TOL)
        faults[fault] = err
        log(f"  planted fault {fault}: max_abs_err {err:.3e}, "
            f"{'caught' if caught else 'MISSED'}")
        if not caught:
            raise SystemExit(f"the attention check misses {fault}")

    name = "self 60x60 act fp32, w bf16"
    t = times[name]
    log(f"  timed case '{name}': kernel {t['kernel']:.3f} ms, library "
        f"{t['library']:.3f} ms, bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}; plain fp32 FMA {t['bound_fp32_fma_ms']:.3f} ms)")
    entry = {"name": "fused_attention", "route": "cuda",
             "source": "emotiongestures_torch/csrc/attention.cu",
             "replaces": "emotiongestures_tpu/ops/pallas_attention.py:35",
             "launches": 0, "max_abs_err": max(errs), "ms": t["kernel"],
             "plain_ms": t["plain"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "library_ms": t["library"]}
    return entry, {"cases": times, "planted_faults": faults}


def mel_library(waves, fb_t):
    """Yardstick only: torch.stft (cuFFT) power spectrum @ filterbank."""
    win = torch.hann_window(M.N_FFT, periodic=True, device=waves.device)
    spec = torch.stft(waves, M.N_FFT, M.HOP, window=win, center=True,
                      pad_mode="reflect", return_complex=True)
    return (spec.abs() ** 2).transpose(1, 2) @ fb_t


def mel_faults(ops):
    """Kernel operands with a planted fault: the largest weight of a
    mid-band filter (mel 64) zeroed; one twiddle (W^100) conjugated."""
    _, length, offset, _ = ops["bands"][64].tolist()
    band_w = ops["band_w"].clone()
    band_w[offset + int(ops["band_w"][offset:offset + length].argmax())] = 0
    tw = ops["tw"].clone()
    tw[100, 1] = -tw[100, 1]
    return {"mel 64's largest weight zeroed": ("band_w", band_w),
            "twiddle W^100 conjugated": ("tw", tw)}


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
        errs.append(check_close(f"{clips} clips x {nf} frames ({clips * nf} "
                                f"frames)", got, ref, **MEL_TOL))
        if entry is not None:
            continue
        ops = FM._operands(padded.device)  # the wrapper's own
        for fault, (key, bad) in mel_faults(ops).items():
            good, ops[key] = ops[key], bad
            try:
                got = FM.mel_power(padded, nf)
                torch.cuda.synchronize()
            finally:
                ops[key] = good
            err = (got - ref).abs().max().item()
            caught = not torch.allclose(got, ref, **MEL_TOL)
            log(f"    planted fault {fault}: max_abs_err {err:.3e}, "
                f"{'caught' if caught else 'MISSED'}")
            if not caught:
                raise SystemExit(f"the mel check misses {fault}")
        lib = mel_library(waves, fb_t)
        check_close("  library yardstick (torch.stft) vs plain", lib, ref,
                    **MEL_TOL)
        k_ms = cuda_ms(lambda: FM.mel_power(padded, nf), iters=20)
        p_ms = cuda_ms(lambda: FM.mel_power_plain(padded, nf))
        l_ms = cuda_ms(lambda: mel_library(waves, fb_t), iters=20)
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
        # what this kernel does per frame (csrc/mel.cu): the window; three
        # radix-8 passes of 64 butterflies (56 flops each), twiddles in two
        # of them (7 complex products, 6 flops each); the split step for
        # 256 pairs (~30 flops each); the band dot products. Its shared
        # memory traffic per frame: the span stored once per tile, each pass
        # reading and writing 512 complex values (pass 1 reads the span),
        # the split reading 512 and writing 513 powers, the bands reading
        # their 1,009 powers.
        design = T * (M.N_FFT + 3 * 64 * 56 + 2 * 64 * 7 * 6 + 256 * 30
                      + 2 * fb_nnz)
        F = MEL_TILE
        span = ((F - 1) * M.HOP + M.N_FFT) / F * 4
        shared = T * (span + 3 * 2 * 512 * 8 + 512 * 8 + bins * 4
                      + fb_nnz * 4)
        log(f"    kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, library "
            f"{l_ms:.3f} ms; least work {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e9:.3f} GB, bound {b_ms:.3f} ms ({b_by}); the "
            f"kernel's FFT does {design / 1e9:.2f} GFLOP and moves "
            f"{shared / 1e9:.2f} GB through shared memory")
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
        if precision == "bfloat16":
            R, n = FS.cluster_layout(H, W)
            clusters = FS.active_clusters(H, W)
            log(f"    one launch per stage: clusters of {n} CTAs x {R} rows, "
                f"{clusters} resident at once "
                f"(cudaOccupancyMaxActiveClusters)")
            # from the card's occupancy query, not measured: the log and
            # result.json only, never the kernels line
            detail["bf16_active_clusters"] = clusters
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
    ("attention kernel (csrc/attention.cu)", ("mha_qkv", "mha_core",
                                              "mha_out_ln")),
    ("mel kernel (csrc/mel.cu)", ("mel_fft_kernel",)),
    ("convolution (cuDNN)", ("fprop", "conv", "cudnn", "dgrad", "wgrad",
                             "fft", "pointwise_mult_and_sum")),
    ("matmul (cuBLAS/CUTLASS)", ("gemm", "cutlass", "matmul")),
    ("optimizer (Adam, foreach)", ("multi_tensor_apply",)),
    ("elementwise and reductions", ("elementwise", "reduce", "softmax",
                                    "cat", "copy", "fill", "index")),
)


def kernel_split(prof):
    """CUDA kernel time of a torch.profiler run by KERNEL_GROUPS, and each
    kernel's (ms, count, name)."""
    groups, top = {}, []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.key
        if name.startswith("Optimizer."):
            continue  # the optimizer's record_function span, not a kernel
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        top.append((us / 1e3, evt.count, name[:90]))
    return groups, top


def log_split(label, wall_ms, groups, top) -> float:
    busy = sum(groups.values())
    log(f"  {label}: wall {wall_ms:.1f} ms (under the profiler), CUDA "
        f"kernels {busy:.1f} ms, device busy share {busy / wall_ms:.3f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:9.2f} ms  {100 * ms / busy:5.1f}%  {g}")
    for ms, n, name in sorted(top, reverse=True)[:12]:
        log(f"      {ms:8.2f} ms  x{n:<4d} {name}")
    return busy


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
    groups, top = kernel_split(prof)
    busy = log_split(f"profile ({precision}, [{card}])", wall_ms, groups,
                     top)
    attn = [(ms, n, name) for ms, n, name in top
            if any(k in name.lower() for k in KERNEL_GROUPS[0][1])]
    log("    attention kernels:")
    for ms, n, name in sorted(attn, reverse=True):
        log(f"      {ms:8.2f} ms  x{n:<4d} {name}")
    return {"precision": precision, "wall_ms": wall_ms, "kernel_ms": busy,
            "groups_ms": groups,
            "attention_kernels_ms": {name: ms for ms, _, name in attn}}


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


# ---------------------------------------------------------------------------
# phase 6: GAN training
# ---------------------------------------------------------------------------

TRAIN_SAMPLES, TRAIN_BATCH = 512, 128
# each run's flags and the GANConfig fields its preset sets
TRAIN_RUNS = {
    "fp32": (["--preset", "parity"],
             dict(compute_dtype="float32", update_order="d_first")),
    "fast": (["--preset", "fast"],
             dict(compute_dtype="bfloat16", update_order="g_first")),
}
# 6c, one train step on the card against the CPU, fp32 with TF32 off:
# losses rtol 1e-4; Adam moments rtol 1e-3, atol 1e-3 of the tensor's
# largest entry, except where fp32 gradients are ill-conditioned in any
# implementation (the audio encoder's SE-ResNet: up to 6.6e-2 of the largest
# entry from a float64 run on the CPU, tests/test_torch_port_train_dfirst.py)
# at 0.15 of it, and final_conv1.bias, whose exact gradient is zero (it
# feeds a train-mode BatchNorm), within mu 1e-6 / nu 1e-12; running
# statistics rtol 1e-4, atol 1e-5; parameters atol 2.02 * lr (Adam's first
# update is about lr * sign(g); 1% for the rounding of the weights)
STEP_CFG = dict(d_model=128, d_inner=256, n_layers=1)
STEP_B = 8
ILL = "audio_encoder.feat_extractor."
ZERO_GRAD = "audio_encoder.final_conv1.bias"


def train_once(name, extra, model_dir, epochs, resume):
    args = train_cli.build_parser().parse_args([
        "--synthetic", str(TRAIN_SAMPLES), "--batch_size", str(TRAIN_BATCH),
        "--total_epoch", str(epochs), "--device", "cuda", "--save_every",
        "1000", "--model_save_path", str(model_dir), *extra,
        *(["--resume"] if resume else [])])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    gen, disc, summary = train_cli.main(args)
    launches = (FA.launches, FM.launches, FS.launches)
    if launches != (0, 0, 0):
        raise SystemExit(f"train {name}: kernel launches during training "
                         f"(attention, mel, SE stage) = {launches}")
    bad = [k for k, v in summary["metrics"].items() if not np.isfinite(v)]
    if bad:
        raise SystemExit(f"train {name}: non-finite losses {bad}")
    summary["peak_bytes"] = torch.cuda.max_memory_allocated()
    return gen, disc, summary


def profile_train_step(gen_state, disc_state, cfg, card):
    """With --profile: one train step at batch 128 under torch.profiler,
    CUDA kernel time by group and the device's busy share of the step."""
    batch = {k: v.cuda() for k, v in train_batch(TRAIN_BATCH).items()}
    gan.train_step(gen_state, disc_state, batch, 0, cfg)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        gan.train_step(gen_state, disc_state, batch, 1, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = kernel_split(prof)
    busy = log_split(f"profiled train step ({cfg.compute_dtype}, "
                     f"{cfg.update_order}, [{card}])", wall_ms, groups, top)
    return {"wall_ms": wall_ms, "kernel_ms": busy, "groups_ms": groups}


def train_batch(b):
    ds = SyntheticGestureDataset(n_samples=b, seed=1)
    batch = next(ds.batches(b, shuffle=False,
                            fields=train_cli.BATCH_KEYS))
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def phase_train(card, profiling=False):
    results = {}
    for (name, (extra, fields)), tag in zip(TRAIN_RUNS.items(), "ab"):
        log(f"phase 6{tag} ({name}): trainer main {' '.join(extra)} "
            f"--synthetic {TRAIN_SAMPLES} --batch_size {TRAIN_BATCH} "
            f"--total_epoch 2, then --resume --total_epoch 1")
        with tempfile.TemporaryDirectory() as model_dir:
            gen, disc, first = train_once(name, extra, model_dir, 2, False)
            if (gen.step, disc.step) != (8, 8):
                raise SystemExit(f"train {name}: steps {gen.step}, "
                                 f"{disc.step} after 2 epochs (want 8)")
            gen, disc, resumed = train_once(name, extra, model_dir, 1, True)
            if (gen.step, disc.step) != (12, 12):
                raise SystemExit(f"train {name}: steps {gen.step}, "
                                 f"{disc.step} after --resume (want 12)")
            profile = (profile_train_step(gen, disc,
                                          gan.GANConfig(**fields), card)
                       if profiling else None)
        steady = first["step_ms"][2:]
        ms = float(np.mean(steady))
        res = {"ms_per_step": ms, "samples_per_s": TRAIN_BATCH / ms * 1e3,
               "step_ms": first["step_ms"],
               "resume_step_ms": resumed["step_ms"],
               "peak_bytes": max(first["peak_bytes"],
                                 resumed["peak_bytes"]),
               "wall_s": first["wall_s"], "resume_wall_s": resumed["wall_s"],
               "losses": resumed["metrics"], "attention_launches": 0,
               "profile": profile}
        log(f"  [{card}] {name}: {ms:.2f} ms per step (CUDA events, mean "
            f"of steps 3-8; all: "
            f"{', '.join(f'{t:.2f}' for t in first['step_ms'])}; "
            f"resumed: {', '.join(f'{t:.2f}' for t in resumed['step_ms'])})"
            f", {res['samples_per_s']:.1f} samples/s, peak "
            f"{res['peak_bytes'] / 2**30:.2f} GiB allocated, wall "
            f"{first['wall_s']:.1f} s + {resumed['wall_s']:.1f} s")
        log(f"  [{card}] {name}: steps 8 -> 12 for G and D; last losses "
            + ", ".join(f"{k} {v:.5f}" for k, v in res["losses"].items())
            + "; attention, mel and SE-stage launches 0")
        results[name] = res
    results["card_vs_cpu"] = phase_train_step()
    return results


def step_states(device):
    cfg = gan.GANConfig(**STEP_CFG)
    gs, ds = gan.create_states(cfg, 0, device=device)
    for module in (gs.module, ds.module):
        for d in module.modules():
            if isinstance(d, L.Dropout):
                d.p = 0.0
    return cfg, gs, ds


def one_step(device, batch):
    cfg, gs, ds = step_states(device)
    gs, ds, m = gan.train_step(
        gs, ds, {k: v.to(device) for k, v in batch.items()}, 1, cfg)
    return cfg, gs, ds, {k: float(v) for k, v in m.items()}


def step_errors(card, cpu):
    """Worst error of each compared quantity and the list of tolerance
    violations, card against CPU."""
    (cfg, g1, d1, m1), (_, g0, d0, m0) = card, cpu
    worst, bad = {}, []

    def check(what, name, got, want, rtol, atol):
        got, want = got.detach().double().cpu(), want.detach().double()
        err = (got - want).abs()
        worst[what] = max(worst.get(what, 0.0), float(err.max()))
        if bool((err > atol + rtol * want.abs()).any()):
            bad.append(f"{what} {name}")

    for k, v in m0.items():
        check("losses", k, torch.tensor(m1[k]), torch.tensor(v), 1e-4, 1e-6)
    for net, (s1, s0) in {"G": (g1, g0), "D": (d1, d0)}.items():
        p1 = dict(s1.module.named_parameters())
        for name, p in s0.module.named_parameters():
            check("params", f"{net} {name}", p1[name], p, 0.0,
                  2.02 * cfg.lr)
            for key, zero_atol in (("exp_avg", 1e-6), ("exp_avg_sq", 1e-12)):
                want = s0.optimizer.state[p][key]
                got = s1.optimizer.state[p1[name]][key]
                scale = float(want.abs().max())
                if name == ZERO_GRAD:
                    rtol, atol = 0.0, zero_atol
                elif name.startswith(ILL):
                    rtol, atol = 1e-3, 0.15 * scale
                else:
                    rtol, atol = 1e-3, 1e-3 * scale
                check(key, f"{net} {name}", got, want, rtol, atol)
        b1 = dict(s1.module.named_buffers())
        for name, b in s0.module.named_buffers():
            check("running stats", f"{net} {name}", b1[name], b, 1e-4, 1e-5)
    return worst, bad


def torch_momentum(self, mean, var):
    """The planted fault: torch's convention, running = 0.1 * running +
    0.9 * batch."""
    self.running_mean.copy_(0.1 * self.running_mean + 0.9 * mean)
    self.running_var.copy_(0.1 * self.running_var + 0.9 * var)


def phase_train_step():
    log(f"phase 6c: one d_first train step, d_model 128, one layer, batch "
        f"{STEP_B}, dropout off, the card against the CPU")
    batch = train_batch(STEP_B)
    cpu = one_step("cpu", batch)
    worst, bad = step_errors(one_step("cuda", batch), cpu)
    log("  max_abs_err " + ", ".join(f"{k} {v:.3e}" for k, v in
                                     worst.items())
        + f" ({'ok' if not bad else 'FAIL: ' + ', '.join(bad[:5])})")
    if bad:
        raise SystemExit("train step: the card disagrees with the CPU")
    honest = L.BatchNorm.update_running
    L.BatchNorm.update_running = torch.no_grad()(torch_momentum)
    try:
        faulty = one_step("cuda", batch)
    finally:
        L.BatchNorm.update_running = honest
    fworst, fbad = step_errors(faulty, cpu)
    caught = bool(fbad)
    log(f"  planted fault torch_momentum: running stats max_abs_err "
        f"{fworst['running stats']:.3e}, {len(fbad)} tensors out of "
        f"tolerance, {'caught' if caught else 'MISSED'}")
    if not caught:
        raise SystemExit("the train-step check misses torch_momentum")
    return {"max_abs_err": worst, "planted_fault_caught": caught}


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
    attn_entry, attn_detail = phase_attention(gen)
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
    train = phase_train(card, args.profile)
    entries = (attn_entry, mel_entry, se_entry)
    for e in entries:
        e["launches"] = counts[e["name"]]
        if e["launches"] < 1:
            raise SystemExit(f"{e['name']}: not launched on the main path")

    detail = {"card": card, "serving": serving, "eval": evals,
              "train": train, "se_stage": se_detail,
              "attention": attn_detail}
    (args.out / "result.json").write_text(json.dumps(detail, indent=1))
    log(json.dumps({"serving": serving, "train": {
        k: {m: v[m] for m in ("ms_per_step", "samples_per_s", "peak_bytes")}
        for k, v in train.items() if k in TRAIN_RUNS}}))
    log(card)
    log(json.dumps({"kernels": list(entries)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
