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
     times and the bound of the same work;
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
     seeded in torch.

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
from emotiongestures_torch.core.device import fp32_exact_on_cuda  # noqa: E402
from emotiongestures_torch.ops import cuda_lib  # noqa: E402
from emotiongestures_torch.ops import fused_attention as FA  # noqa: E402
from emotiongestures_torch.ops import fused_mel as FM  # noqa: E402
from emotiongestures_torch.ops import mel as M  # noqa: E402
from emotiongestures_torch.nn import transformer as T  # noqa: E402
from emotiongestures_torch.serving import (  # noqa: E402
    GestureServer,
    set_fused_attention,
)

# NVIDIA H100 SXM data sheet, dense: fp32 outside the tensor cores, HBM3
FP32_PEAK = 67e12
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


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_BYTES_PER_S
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


# ---------------------------------------------------------------------------
# phases 3 and 4: the entry points
# ---------------------------------------------------------------------------

def reset_counts():
    FA.launches = 0
    FM.launches = 0


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
    phase_demo(args.out)
    counts = {"fused_attention": 0, "mel": 0}
    serving = [phase_serving(p, gen, card, counts, args.profile)
               for p in ("float32", "bfloat16")]
    attn_entry["launches"] = counts["fused_attention"]
    mel_entry["launches"] = counts["mel"]
    for e in (attn_entry, mel_entry):
        if e["launches"] < 1:
            raise SystemExit(f"{e['name']}: not launched on the main path")

    detail = {"card": card, "serving": serving,
              "attention_cases_ms": {k: {"kernel": v[0], "plain": v[1],
                                         "library": v[2]}
                                     for k, v in attn_times.items()}}
    (args.out / "result.json").write_text(json.dumps(detail, indent=1))
    log(json.dumps({"serving": serving}))
    log(card)
    log(json.dumps({"kernels": [attn_entry, mel_entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
