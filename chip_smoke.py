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
     fail. The fp32 run's --model_save_path stays for phase 7;
  7. the auxiliary trainers through `train_auxiliary.main` at full width,
     batch 128, 512 synthetic samples, fp32: 7a the FGD autoencoder (pose
     282, latent 512) and the skeleton classifier (d_model 512, d_inner
     2048, 3 layers, 8 heads, 60 frames), 7b the CVAE v3 (feat_dim 512) on
     the emotion features of phase 6's fp32 generator, loaded from its
     directory; each 2 epochs (8 steps), then --resume to step 12. 7c the
     eval CLI's `main` (--synthetic 256, batches of 128) on phase 6's
     generator and the three new checkpoint directories: all four loaded,
     finite metrics. 7d one step of each trainer at a reduced width
     (skeleton d_model 64, CVAE feat_dim 64), batch 8, dropout off, the
     CVAE's noise injected, on the card and on the CPU, with 6c's
     tolerances;
  8. the K-fold classifier through `train_audio_classifier_K_fold.main`:
     8a EmotionNet at (128, 124) (4-stage SE-ResNet [3, 4, 6, 3] x [32,
     64, 128, 256], MLP 65,536 -> 4096 -> ... -> 8), 512 synthetic
     samples, batch 128, 2 epochs of fold 1 (6 steps), --preset parity
     (fp32) and --preset fast (bf16 compute); 8b the resume contract on
     the card (40 spectrograms of 32 x 32, 4 splits, batch 8, 4 epochs:
     stopped mid-fold, resumed, folds 0 and 1 finish, fold 0 at step 12,
     the checkpoint before it); 8c one classifier step at 32 x 32, batch
     8, on the card and on the CPU, with 6c's tolerances (the SE-ResNet's
     moments loosely). Phases 6-8: ms per step (CUDA events, the mean of
     steps 3 onwards), samples/s, peak allocated memory and wall time per
     trainer, and no kernel launch during training;
  9. the real-data stack, store-fed, in one temp directory: 9a a BEAT-shaped
     clip store from a numpy seed (68 clips of 64 s: 16 kHz audio_raw, no
     audio_feat, 94 joints at 15 fps, a timed word every ~0.3 s, eids over
     all 8 classes) through `DataPreprocessor` twice, the 'pallas'
     frontend (the mel kernel, one launch per clip) and 'xla' (its plain
     version): 2108 windows each, spectrograms within 0.08 dB, every other
     field equal, the preprocessing wall of each; 9b the eval CLI's `main`
     on that store (--preset fast, 2 batches of 1024, 2 diversity passes):
     finite metrics, 6 attention launches per eval_batch, every batch
     through the native gather, vocab_all.pkl written and reloaded, its
     eval_batch ms, wall and data wait beside phase 5's; 9c the GAN
     trainer's `main` on the store at full width (--preset fast, batch
     128, one epoch: 16 steps, the vocabulary's words): finite losses, no
     kernel launch, ms per step beside phase 6b's, and with --profile the
     card's busy share over traced steps 4-8; 9d the FGD trainer (2 steps)
     and the K-fold trainer (--max_folds 1, one epoch: 3 steps) on the
     store's first 217 windows as train, val and test: finite losses;
 10. data parallelism: two ranks spawned on the one card, joined over gloo
     (NCCL refuses two ranks on one device), against one process: 10a a
     GAN train_step at full width, global batch 128 (64 per rank), dropout
     on, 2 steps, `--preset parity` and `--preset fast`, the one-process
     run computed in rank 0 under `mesh.single_process()`, held to
     tests/test_parallel.py's criteria (bf16's from its reading, DP_TOL),
     and with BatchNorm on per-rank statistics planted, which must fail;
     10b eval_batch at full width, global batch 1024, in both presets:
     poses, FGD features and TMMemory's output against one process
     (DP_EVAL_TOL, DP_TM_TOL), 6 attention launches per eval_batch on each
     rank under `--preset fast`, and TMMemory coupled per rank planted,
     which the fp32 check must fail; 10c the GAN trainer's `main` in the
     group (`--preset fast`, 512 samples, 2 epochs, then `--resume` to step
     12; one log and the checkpoints from rank 0) and the eval CLI's `main`
     (phase 5's fast run; metrics against phase 5's, DP_EVAL_REL; 6
     launches per eval_batch per rank); with a second card, the trainer
     with `--num_devices 2` over NCCL. ms per step and per eval_batch of
     each rank (two processes time-slicing one card: not a scaling figure)
     and the phase's wall;
 11. the data-migration path, in phase 9's temp directory: 11a a raw clip
     LMDB of 9a's 68 clips (one video per record, its clip nested, a seeded
     float16 audio_feat each; written with the port's arrow014.serialize
     and tests/fixtures/make_lmdb_fixture.py's write_lmdb) through
     `convert_data clips` (every field equal to its source) and
     DataPreprocessor's 'pallas' frontend: 2108 windows equal to 9a's byte
     for byte, 68 mel launches; 11b a BEAT-layout cache LMDB (5-tuples) of
     9a's 2108 windows through `convert_data cache`: the store equals 9a's
     byte for byte, and the eval CLI's `main` on it with 9b's flags gives
     9b's metrics (MIGRATED_EVAL_REL) with 6 attention launches per
     eval_batch; a TED-layout cache LMDB (6-tuples with vec_seq) of 300
     windows at TED's shapes converts with every field equal; 11c
     BeatAlignerV1 over the converted windows with the onset frontend on
     the card and on the host (BEAT_FRONTEND_TOL), and `convert_data
     wordvec` on 9b's vocab_all.pkl and a seeded 300-d .vec, installed by
     `set_pretrained_embedding` in the flagship generator on the card: the
     rows equal the .npy and a forward at batch 1024 is finite (6
     attention launches). Each conversion's wall, records/s and MB/s, the
     LMDB sizes and depths, and the phase's wall.
 12. the model zoo, in the work directory of phases 6-11: 12a each of the
     generator variants `base`, `spatial_memory` and `padding_initial`
     served as phase 4 (EmotionCVAEv3.sample, then GestureTransformer(
     variant=..., fused_attention=True) at full width, batch 1024, fp32 and
     bf16, weights seeded in torch): exactly 6 attention launches per
     forward, the poses within POSE_TOL of the plain attention path, 2
     fp32 rows on the card against the CPU, ms per forward beside phase
     4's `memory`; 12b the GAN trainer's `main` once per `--variant`
     (`--preset fast`, batch 128, 512 synthetic samples, one epoch: finite
     losses, no kernel launch, ms per step) and one fp32 d_first
     train_step of `base` and of `padding_initial` at 6c's width on the
     card and on the CPU under 6c's tolerances, SPMemoryV2's running
     statistics among the buffers; 12c `train_auxiliary --model cvae
     --cvae_version 1`, then 2, on phase 6's fp32 generator (2 epochs,
     then `--resume` to step 12), one step of each on the card and on the
     CPU with the noise injected under 7d's tolerances, and HandCVAE's
     forward and prior sample card vs CPU (ZOO_REL); 12d every baseline
     (seq2seq, speech2gesture, trimodal, hierarchy with its speaker
     blend, the embedding net, the motion autoencoder), their
     discriminators and the legacy factories at the JAX constructors'
     default widths, batch 64, fp32 with TF32 off, on the card and on the
     CPU (ZOO_REL), ms per forward, no kernel launch; then 8 batches of 64
     windows into EmbeddingSpaceEvaluator at pose_dim 27 and 126 on the
     card and on the CPU: Fréchet distance, feature distance and
     diversity within ZOO_EVAL_REL. Each part's wall and the phase's.
 13. the JAX package's orbax checkpoints and the remaining tools, in the
     work directory: 13a phase 4's serving weights (the flagship generator
     and CVAE v3) laid out as the JAX package's TrainStates (step 40,
     seeded Adam moments) and written by tests/fixtures/
     make_orbax_fixture.py's write_orbax (OCDBT, zarr v2, raw-block zstd
     frames; numpy only), then read by the port (utils/orbax.py, the C++
     zstd decoder built with g++ in phase 1): GestureServer's modules in
     fp32 and bf16 (read wall, MB/s, zstd MB/s; ms per forward of 1024
     beside phase 4's; 6 attention launches; fp32 poses equal to the
     source's bit for bit), the eval CLI's build_models and one
     eval_batch of 1024 (every output equal to the source modules' bit
     for bit, 6 launches) and the demo (--frontend pallas, poses equal to
     its run on .pth files of the same modules, 1 mel launch); 13b the
     checkpoints the JAX package's save_checkpoint wrote
     (tests/fixtures/orbax_jax: zstd's Huffman and FSE blocks, orbax's
     merged OCDBT tree) against JAX's outputs (JAX_FIXTURE_TOL), and the
     decoder's MB/s on their chunks; 13c a reference .pth of the flagship
     generator through convert_checkpoint, then the GAN trainer's `main`
     --resume for 2 steps from step 0, and from 13a's orbax generator:
     the step and Adam's moments carried bit for bit, steps 41-42; 13d
     ops/conv_gemm.py's taps and im2col against F.conv2d at stage 3 (B
     128, 32 x 31, C = K = 128), fp32 and bf16 (CONV_TOL), ms of each;
     13e the demo's --render: with matplotlib the first sample drawn,
     without it the refusal before any model is built. Each part's wall
     and the phase's.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or without the
repository around it, the script fails before printing a result.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from emotiongestures_torch.cli import (  # noqa: E402
    convert_checkpoint as convert_ckpt_cli,
)
from emotiongestures_torch.cli import convert_data as convert_cli  # noqa: E402,E501
from emotiongestures_torch.cli import demo  # noqa: E402
from emotiongestures_torch.cli import (  # noqa: E402
    test_emotion_gesture_diversity_iterative as eval_cli,
)
from emotiongestures_torch.cli import (  # noqa: E402
    train_audio_classifier_K_fold as kfold_cli,
)
from emotiongestures_torch.cli import train_auxiliary as aux_cli  # noqa: E402
from emotiongestures_torch.cli import (  # noqa: E402
    train_emotion_gesture as train_cli,
)
from emotiongestures_torch.core import layers as L  # noqa: E402
from emotiongestures_torch.core import precision as prec  # noqa: E402
from emotiongestures_torch.core.device import fp32_exact_on_cuda  # noqa: E402
from emotiongestures_torch.ops import conv_gemm  # noqa: E402
from emotiongestures_torch.ops import cuda_lib  # noqa: E402
from emotiongestures_torch.parallel import distributed, mesh  # noqa: E402
from emotiongestures_torch.ops import fused_attention as FA  # noqa: E402
from emotiongestures_torch.ops import fused_mel as FM  # noqa: E402
from emotiongestures_torch.ops import fused_se_stage as FS  # noqa: E402
from emotiongestures_torch.ops import mel as M  # noqa: E402
from emotiongestures_torch.data import arrow014  # noqa: E402
from emotiongestures_torch.data import dataset as dataset_mod  # noqa: E402
from emotiongestures_torch.data.lmdb_reader import LmdbEnv  # noqa: E402
from emotiongestures_torch.data.preprocessing import (  # noqa: E402
    DataPreprocessor,
)
from emotiongestures_torch.data.store import (  # noqa: E402
    GestureStore,
    GestureStoreWriter,
)
from emotiongestures_torch.data.synthetic import (  # noqa: E402
    SyntheticGestureDataset,
)
from emotiongestures_torch.data.vocab import Vocab, build_vocab  # noqa: E402
from emotiongestures_torch.eval.beat import BeatAlignerV1  # noqa: E402
from emotiongestures_torch.eval import (  # noqa: E402
    embedding_space_evaluator as zoo_eval,
)
from emotiongestures_torch.models import baselines as bl  # noqa: E402
from emotiongestures_torch.models import cvae as cvae_models  # noqa: E402
from emotiongestures_torch.models import generator as gen_mod  # noqa: E402
from emotiongestures_torch.models import legacy_submodules as legacy  # noqa: E402,E501
from emotiongestures_torch.nn import transformer as T  # noqa: E402
from emotiongestures_torch.nn.resnet_se import SEBasicBlock  # noqa: E402
from emotiongestures_torch.serving import (  # noqa: E402
    GestureServer,
    set_fused_attention,
)
from emotiongestures_torch.train import classifier  # noqa: E402
from emotiongestures_torch.train import cvae as cvae_train  # noqa: E402
from emotiongestures_torch.train import fgd as fgd_train  # noqa: E402
from emotiongestures_torch.train import gan  # noqa: E402
from emotiongestures_torch.train import skeleton as skeleton_train  # noqa: E402,E501
from emotiongestures_torch.models.fgd_ae import FGDAutoEncoder  # noqa: E402
from emotiongestures_torch.utils import ocdbt, weights  # noqa: E402
from emotiongestures_torch.utils import zstd as zstd_mod  # noqa: E402
from emotiongestures_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)

# NVIDIA H100 SXM data sheet, dense: fp32 outside the tensor cores, TF32 and
# bf16 on the tensor cores, HBM3
FP32_PEAK = 67e12
TF32_PEAK = 495e12
BF16_PEAK = 989e12
HBM_BYTES_PER_S = 3.35e12
BATCH = 1024
# the training phases' device (6-8); a rehearsal on the CPU at small sizes
# sets it to "cpu"
DEVICE = "cuda"
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
EPOCH_STEPS = TRAIN_SAMPLES // TRAIN_BATCH
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
        "--total_epoch", str(epochs), "--device", DEVICE, "--save_every",
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


def phase_train(card, work: Path, profiling=False):
    """Phase 6. The fp32 run's --model_save_path, work / "gan_fp32", stays
    for phase 7 (the CVAE's frozen generator and the eval's checkpoints);
    the bf16 run's is removed."""
    results = {}
    for (name, (extra, fields)), tag in zip(TRAIN_RUNS.items(), "ab"):
        log(f"phase 6{tag} ({name}): trainer main {' '.join(extra)} "
            f"--synthetic {TRAIN_SAMPLES} --batch_size {TRAIN_BATCH} "
            f"--total_epoch 2, then --resume --total_epoch 1")
        model_dir = work / f"gan_{name}"
        gen, disc, first = train_once(name, extra, model_dir, 2, False)
        if (gen.step, disc.step) != (2 * EPOCH_STEPS, 2 * EPOCH_STEPS):
            raise SystemExit(f"train {name}: steps {gen.step}, "
                             f"{disc.step} after 2 epochs (want "
                             f"{2 * EPOCH_STEPS})")
        gen, disc, resumed = train_once(name, extra, model_dir, 1, True)
        if (gen.step, disc.step) != (3 * EPOCH_STEPS, 3 * EPOCH_STEPS):
            raise SystemExit(f"train {name}: steps {gen.step}, "
                             f"{disc.step} after --resume (want "
                             f"{3 * EPOCH_STEPS})")
        profile = (profile_train_step(gen, disc, gan.GANConfig(**fields),
                                      card)
                   if profiling else None)
        del gen, disc
        if name != "fp32":
            shutil.rmtree(model_dir)
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


def step_states(device, variant="memory"):
    cfg = gan.GANConfig(**STEP_CFG, variant=variant)
    gs, ds = gan.create_states(cfg, 0, device=device)
    for module in (gs.module, ds.module):
        for d in module.modules():
            if isinstance(d, L.Dropout):
                d.p = 0.0
    return cfg, gs, ds


def one_step(device, batch, variant="memory"):
    cfg, gs, ds = step_states(device, variant)
    gs, ds, m = gan.train_step(
        gs, ds, {k: v.to(device) for k, v in batch.items()}, 1, cfg)
    return cfg, gs, ds, {k: float(v) for k, v in m.items()}


def state_errors(pairs, m1, m0, lr, loose=None, zero=None):
    """Worst error of each compared quantity (Adam's moments also as a share
    of their tensor's scale, `zero` left out) and the list of tolerance violations of train
    states on the card against the CPU, with 6c's tolerances. `pairs` maps
    a net's label to (card state, CPU state); `m1`, `m0` are the two
    steps' losses. Parameters under the prefix `loose` take the loose
    moments; `zero` names one whose exact gradient is zero."""
    worst, bad = {}, []

    def check(what, name, got, want, rtol, atol, share=False):
        got, want = got.detach().double().cpu(), want.detach().double()
        err = (got - want).abs()
        worst[what] = max(worst.get(what, 0.0), float(err.max()))
        if share:
            key = f"{what} / scale"
            share = float(err.max() / want.abs().max().clamp(min=1e-30))
            worst[key] = max(worst.get(key, 0.0), share)
        if bool((err > atol + rtol * want.abs()).any()):
            bad.append(f"{what} {name}")

    for k, v in m0.items():
        check("losses", k, torch.tensor(m1[k]), torch.tensor(v), 1e-4, 1e-6)
    for net, (s1, s0) in pairs.items():
        p1 = dict(s1.module.named_parameters())
        for name, p in s0.module.named_parameters():
            label = f"{net} {name}".strip()
            check("params", label, p1[name], p, 0.0, 2.02 * lr)
            for key, zero_atol in (("exp_avg", 1e-6), ("exp_avg_sq", 1e-12)):
                want = s0.optimizer.state[p][key]
                got = s1.optimizer.state[p1[name]][key]
                scale = float(want.abs().max())
                if name == zero:
                    rtol, atol = 0.0, zero_atol
                elif loose is not None and name.startswith(loose):
                    rtol, atol = 1e-3, 0.15 * scale
                else:
                    rtol, atol = 1e-3, 1e-3 * scale
                check(key, label, got, want, rtol, atol, share=name != zero)
        b1 = dict(s1.module.named_buffers())
        for name, b in s0.module.named_buffers():
            check("running stats", f"{net} {name}".strip(), b1[name], b,
                  1e-4, 1e-5)
    return worst, bad


def step_errors(card, cpu):
    """6c: the generator and the discriminator, card against CPU."""
    (cfg, g1, d1, m1), (_, g0, d0, m0) = card, cpu
    return state_errors({"G": (g1, g0), "D": (d1, d0)}, m1, m0, cfg.lr,
                        ILL, ZERO_GRAD)


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
    worst, bad = step_errors(one_step(DEVICE, batch), cpu)
    log("  max_abs_err " + ", ".join(f"{k} {v:.3e}" for k, v in
                                     worst.items())
        + f" ({'ok' if not bad else 'FAIL: ' + ', '.join(bad[:5])})")
    if bad:
        raise SystemExit("train step: the card disagrees with the CPU")
    honest = L.BatchNorm.update_running
    L.BatchNorm.update_running = torch.no_grad()(torch_momentum)
    try:
        faulty = one_step(DEVICE, batch)
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


# ---------------------------------------------------------------------------
# phases 7 and 8: the auxiliary trainers and the K-fold audio classifier
# ---------------------------------------------------------------------------

AUX_MODELS = ("fgd", "skeleton", "cvae")
# 7d and 8c, one step on the card against the CPU, fp32 with TF32 off, the
# tolerances of 6c; the classifier's SE-ResNet takes 6c's loose moments
AUX_STEP_B = 8
AUX_SKELETON = dict(d_model=64, d_inner=128)
AUX_FEAT_DIM = 64
KFOLD_SAMPLES = 512
KFOLD_PRESETS = ("parity", "fast")
SMALL_SPEC = (32, 32)


def assert_no_launches(what):
    launches = (FA.launches, FM.launches, FS.launches)
    if launches != (0, 0, 0):
        raise SystemExit(f"{what}: kernel launches during training "
                         f"(attention, mel, SE stage) = {launches}")


def trainer_numbers(step_ms, batch, peak, wall_s):
    """ms per step (CUDA events, the mean of steps 3 onwards), samples/s,
    peak allocated bytes and wall seconds."""
    ms = float(np.mean(step_ms[2:]))
    return {"ms_per_step": ms, "samples_per_s": batch / ms * 1e3,
            "peak_bytes": peak, "wall_s": wall_s, "step_ms": step_ms}


def log_trainer(card, name, res, extra=""):
    log(f"  [{card}] {name}: {res['ms_per_step']:.2f} ms per step (CUDA "
        f"events, mean of steps 3 onwards; all: "
        f"{', '.join(f'{t:.2f}' for t in res['step_ms'])}), "
        f"{res['samples_per_s']:.1f} samples/s, peak "
        f"{res['peak_bytes'] / 2**30:.2f} GiB allocated, wall "
        f"{res['wall_s']:.1f} s{extra}")


def aux_once(model, work: Path, epochs, resume, extra=(), save="aux"):
    args = aux_cli.build_parser().parse_args([
        "--model", model, "--synthetic", str(TRAIN_SAMPLES), "--batch_size",
        str(TRAIN_BATCH), "--total_epoch", str(epochs), "--device", DEVICE,
        "--save_every", "1000", "--model_save_path", str(work / save),
        *extra, *(["--resume"] if resume else [])])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, summary = aux_cli.main(args)
    assert_no_launches(f"auxiliary trainer {model}")
    bad = [k for k, v in summary["metrics"].items() if not np.isfinite(v)]
    if bad:
        raise SystemExit(f"auxiliary trainer {model}: non-finite {bad}")
    summary["peak_bytes"] = torch.cuda.max_memory_allocated()
    return state, summary


def phase_aux(card, work: Path):
    results = {}
    gan_dir = work / "gan_fp32"
    for model, tag in zip(AUX_MODELS, "aab"):
        extra = (["--generator_checkpoint", str(gan_dir)]
                 if model == "cvae" else [])
        log(f"phase 7{tag} ({model}): auxiliary trainer main --model {model} "
            f"{' '.join(extra)} --synthetic {TRAIN_SAMPLES} --batch_size "
            f"{TRAIN_BATCH} --total_epoch 2, then --resume --total_epoch 1")
        state, first = aux_once(model, work, 2, False, extra)
        if state.step != 2 * EPOCH_STEPS:
            raise SystemExit(f"{model}: step {state.step} after 2 epochs "
                             f"(want {2 * EPOCH_STEPS})")
        state, resumed = aux_once(model, work, 1, True, extra)
        if state.step != 3 * EPOCH_STEPS:
            raise SystemExit(f"{model}: step {state.step} after --resume "
                             f"(want {3 * EPOCH_STEPS})")
        del state
        if model == "cvae":
            text = (work / "aux" / "train_cvae.log").read_text()
            if f"loaded generator checkpoint for features: {gan_dir}" \
                    not in text:
                raise SystemExit("cvae: phase 6's generator was not loaded")
            log(f"  the frozen generator: phase 6's fp32 run, {gan_dir}")
        res = trainer_numbers(first["step_ms"], TRAIN_BATCH,
                              max(first["peak_bytes"],
                                  resumed["peak_bytes"]), first["wall_s"])
        res.update(resume_step_ms=resumed["step_ms"],
                   resume_wall_s=resumed["wall_s"],
                   metrics=resumed["metrics"])
        log_trainer(card, model, res,
                    f" + {resumed['wall_s']:.1f} s resumed; steps 8 -> 12; "
                    "last metrics " + ", ".join(
                        f"{k} {v:.5f}" for k, v in res["metrics"].items())
                    + "; attention, mel and SE-stage launches 0")
        results[model] = res
    results["eval"] = phase_aux_eval(card, work)
    results["card_vs_cpu"] = phase_aux_steps()
    return results


def phase_aux_eval(card, work: Path):
    log("phase 7c: eval CLI main --synthetic 256 --test_batch_size 128 on "
        "phase 6's generator and the three checkpoints of 7a-7b")
    aux = work / "aux"
    args = eval_cli.build_parser().parse_args([
        "--synthetic", "256", "--test_batch_size", "128", "--device",
        DEVICE, "--log_save_path", str(work / "eval_logs"),
        "--checkpoints_folder_path", str(work / "gan_fp32"),
        "--fgd_checkpoint", str(aux / "fgd"), "--skeleton_checkpoint",
        str(aux / "skeleton"), "--cvae_checkpoint", str(aux / "cvae")])
    summary = eval_cli.main(args)
    loaded = summary["checkpoints"]
    if None in loaded.values():
        raise SystemExit(f"eval: not every checkpoint loaded: {loaded}")
    bad = [k for k in METRICS if not np.isfinite(summary[k])]
    if bad:
        raise SystemExit(f"eval on trained nets: non-finite metrics {bad}")
    for name, path in loaded.items():
        log(f"  loaded {name}: {Path(path).relative_to(work)}")
    log(f"  [{card}] " + ", ".join(f"{k} {summary[k]:.5f}"
                                   for k in METRICS))
    return {"checkpoints": {k: str(Path(v).relative_to(work))
                            for k, v in loaded.items()},
            **{k: summary[k] for k in METRICS}}


def no_dropout(module):
    for d in module.modules():
        if isinstance(d, L.Dropout):
            d.p = 0.0
    return module


def aux_step(name, device, inputs):
    """One step of trainer `name` at the reduced width, dropout off, on
    `device`; the state and the metrics."""
    batch = {k: v.to(device) for k, v in inputs.items()}
    if name == "fgd":
        state = fgd_train.create_state(0, device=device)
        no_dropout(state.module)
        state, m = fgd_train.train_step(state, batch["pose_seq"], 1)
    elif name == "skeleton":
        state = skeleton_train.create_state(0, **AUX_SKELETON, device=device)
        no_dropout(state.module)
        state, m = skeleton_train.train_step(state, batch["pose_seq"],
                                             batch["eid_label"], 1)
    elif name == "cvae":
        state = cvae_train.create_state(0, feat_dim=AUX_FEAT_DIM,
                                        device=device)
        no_dropout(state.module)
        state, m = cvae_train.train_step(state, batch["features"],
                                         batch["eid_label"], 1,
                                         noise=batch["noise"])
    else:
        state = classifier.create_state(0, spec_shape=SMALL_SPEC,
                                        device=device)
        state, m = classifier.train_step(state, batch["spectrogram"],
                                         batch["eid_label"], batch["alpha"])
    return state, {k: float(v) for k, v in m.items()}


def step_inputs(name):
    g = torch.Generator().manual_seed(7)
    y = torch.nn.functional.one_hot(torch.arange(AUX_STEP_B) % 8, 8).float()
    if name == "classifier":
        spec = torch.randn(AUX_STEP_B, *SMALL_SPEC, generator=g)
        return {"spectrogram": spec, "eid_label": y, "alpha": torch.from_numpy(
            classifier.class_alpha(y.numpy()))}
    batch = train_batch(AUX_STEP_B)
    return {"pose_seq": batch["pose_seq"], "eid_label": y,
            "features": torch.randn(AUX_STEP_B, 60, AUX_FEAT_DIM,
                                    generator=g),
            "noise": torch.randn(AUX_STEP_B, 32, generator=g)}


def compare_step(name, lr, loose_prefix=None):
    inputs = step_inputs(name)
    (s0, m0), (s1, m1) = (aux_step(name, d, inputs) for d in ("cpu",
                                                                DEVICE))
    worst, bad = state_errors({"": (s1, s0)}, m1, m0, lr, loose_prefix)
    log(f"  {name}: max_abs_err " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items())
        + f" ({'ok' if not bad else 'FAIL: ' + ', '.join(bad[:5])})")
    if bad:
        raise SystemExit(f"{name} train step: the card disagrees with the "
                         "CPU")
    return worst


def phase_aux_steps():
    log(f"phase 7d: one step of each auxiliary trainer, batch {AUX_STEP_B}, "
        f"dropout off, the CVAE's noise injected (FGD full width, skeleton "
        f"d_model {AUX_SKELETON['d_model']}, CVAE feat_dim {AUX_FEAT_DIM}), "
        "the card against the CPU")
    return {"fgd": compare_step("fgd", 3e-4),
            "skeleton": compare_step("skeleton", 3e-4),
            "cvae": compare_step("cvae", 2e-4)}


class SmallSpectrograms:
    """8b's in-memory dataset: (32, 32) spectrograms from a seed, one-hot
    labels cycling through the 8 classes."""

    def __init__(self, n_samples, seed):
        r = np.random.RandomState(seed)
        self.items = [{"spectrogram": r.randn(*SMALL_SPEC).astype(
                           np.float32),
                       "eid_label": np.eye(8, dtype=np.float32)[i % 8]}
                      for i in range(n_samples)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def kfold_once(preset, work: Path):
    args = kfold_cli.build_parser().parse_args([
        "--synthetic", str(KFOLD_SAMPLES), "--batch_size", str(TRAIN_BATCH),
        "--total_epoch", "2", "--max_folds", "1", "--device", DEVICE,
        "--preset", preset, "--model_save_path",
        str(work / f"kfold_{preset}")])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    results = kfold_cli.main(args)
    wall_s = time.perf_counter() - t0
    assert_no_launches(f"classifier {preset}")
    if [r["fold"] for r in results] != [0]:
        raise SystemExit(f"classifier {preset}: folds "
                         f"{[r['fold'] for r in results]} (want [0])")
    r = results[0]
    want = 2 * ((KFOLD_SAMPLES - KFOLD_SAMPLES // 10) // TRAIN_BATCH)
    if r["state"].step != want or not np.isfinite(r["test_acc"]):
        raise SystemExit(f"classifier {preset}: step {r['state'].step} "
                         f"(want {want}), test acc {r['test_acc']}")
    res = trainer_numbers(r["step_ms"], TRAIN_BATCH,
                          torch.cuda.max_memory_allocated(), wall_s)
    res.update(test_acc=r["test_acc"], steps=r["state"].step,
               compute_dtype=args.compute_dtype)
    return res


def phase_kfold_resume(work: Path):
    log("phase 8b: the K-fold resume contract on the card: 40 (32 x 32) "
        "spectrograms, 4 splits, batch 8, 4 epochs, eval_every 2, "
        "max_folds 2; stop after 8 polls, resume")
    full, test = SmallSpectrograms(40, 0), SmallSpectrograms(8, 1)
    ckpt = work / "kfold_resume"
    saved = {}

    def checkpoint_fn(state, fold, epoch, it):
        save_checkpoint(state, ckpt, max_to_keep=1)
        saved.update(fold=fold, iter=it)

    polls = {"n": 0}

    def stopper():
        polls["n"] += 1
        return polls["n"] > 8

    kw = dict(batch_size=8, n_splits=4, epochs=4, eval_every=2, seed=0,
              max_folds=2, checkpoint_fn=checkpoint_fn, device=DEVICE)
    reset_counts()
    if classifier.train_k_fold(full, test, should_stop=stopper, **kw) != []:
        raise SystemExit("8b: a fold finished before the stop")
    template = classifier.create_state(0, spec_shape=SMALL_SPEC,
                                       device=DEVICE)
    state, ok = load_checkpoint(template, ckpt)
    at = state.step
    if not ok or saved.get("fold") != 0 or not 2 <= at < 12:
        raise SystemExit(f"8b: checkpoint {ok}, {saved}, step {at}")
    results = classifier.train_k_fold(full, test, resume_from=(state, 0),
                                      **kw)
    assert_no_launches("classifier resume")
    folds = [r["fold"] for r in results]
    if folds != [0, 1] or results[0]["state"] is not state or \
            state.step != 12 or results[1]["state"].step != 12:
        raise SystemExit(f"8b: folds {folds}, fold 0 at step {state.step} "
                         "(want [0, 1], 12 and 12)")
    log(f"  checkpoint at step {at} of fold 0; resumed: folds {folds}, "
        f"fold 0 at step {state.step}, fold 1 at "
        f"{results[1]['state'].step}")
    shutil.rmtree(ckpt)
    return {"checkpoint_step": at, "folds": folds}


def profile_classifier_step(compute_dtype, card):
    """With --profile: one classifier step at batch 128, (128, 124), under
    torch.profiler; CUDA kernel time by group and the device's busy
    share."""
    ds = SyntheticGestureDataset(n_samples=TRAIN_BATCH, seed=1)
    batch = next(ds.batches(TRAIN_BATCH, shuffle=False,
                            fields=("spectrogram", "eid_label")))
    spec, y = (torch.from_numpy(batch[k]).cuda()
               for k in ("spectrogram", "eid_label"))
    alpha = torch.from_numpy(classifier.class_alpha(batch["eid_label"]))
    state = classifier.create_state(0, device="cuda")
    for _ in range(2):  # cuDNN's first calls
        classifier.train_step(state, spec, y, alpha.cuda(),
                              compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        classifier.train_step(state, spec, y, alpha.cuda(),
                              compute_dtype=compute_dtype)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = kernel_split(prof)
    busy = log_split(f"profiled classifier step ({compute_dtype}, [{card}])",
                     wall_ms, groups, top)
    return {"wall_ms": wall_ms, "kernel_ms": busy, "groups_ms": groups}


def phase_kfold(card, work: Path, profiling=False):
    results = {}
    for preset in KFOLD_PRESETS:
        log(f"phase 8a ({preset}): K-fold trainer main --preset {preset} "
            f"--synthetic {KFOLD_SAMPLES} --batch_size {TRAIN_BATCH} "
            "--total_epoch 2 --max_folds 1, EmotionNet at (128, 124)")
        res = kfold_once(preset, work)
        log_trainer(card, f"classifier {res['compute_dtype']}", res,
                    f"; {res['steps']} steps; test accuracy "
                    f"{res['test_acc']:.2f}%; attention, mel and SE-stage "
                    "launches 0")
        if profiling:
            res["profile"] = profile_classifier_step(res["compute_dtype"],
                                                     card)
        results[preset] = res
    results["resume"] = phase_kfold_resume(work)
    log(f"phase 8c: one classifier step, batch {AUX_STEP_B}, spectrogram "
        f"{SMALL_SPEC[0]} x {SMALL_SPEC[1]}, the card against the CPU")
    results["card_vs_cpu"] = compare_step("classifier", 3e-4,
                                          "emotion_encoder.")
    results["fp32_vs_float64"] = classifier_float64_shares()
    return results


def classifier_float64_shares():
    """8c's measurement (no gate): the same classifier step in float64 on
    the card as the reference, and each fp32 step's (card, CPU) worst
    Adam first moment error as a share of its tensor's scale."""
    inputs = step_inputs("classifier")
    state = classifier.create_state(0, spec_shape=SMALL_SPEC, device=DEVICE)
    state.module.double()
    classifier.train_step(state, *(inputs[k].double().to(DEVICE) for k in
                                   ("spectrogram", "eid_label", "alpha")))
    ref = {n: state.optimizer.state[p]["exp_avg"].cpu()
           for n, p in state.module.named_parameters()}
    shares = {}
    for device in (DEVICE, "cpu"):
        s32, _ = aux_step("classifier", device, inputs)
        worst = max(
            (float((s32.optimizer.state[p]["exp_avg"].cpu().double()
                    - ref[n]).abs().max() / ref[n].abs().max()), n)
            for n, p in s32.module.named_parameters())
        shares[device] = {"share": worst[0], "tensor": worst[1]}
        log(f"  fp32 on {device} against float64 on the card: exp_avg off "
            f"by up to {worst[0]:.3e} of its scale ({worst[1]})")
    return shares



# ---------------------------------------------------------------------------
# phase 9: the real-data stack, store-fed
# ---------------------------------------------------------------------------

# a BEAT-shaped clip store: 68 clips of 64 s, 16 kHz audio, 94 joints at
# 15 fps (pose 282), a timed word every ~0.3 s, eids over all 8 classes
STORE_CLIPS, CLIP_S, CLIP_FPS, CLIP_JOINTS = 68, 64, 15, 94
STORE_WORDS = 300
N_POSES, STRIDE = 60, 30
WINDOWS_PER_CLIP = (CLIP_S * CLIP_FPS - N_POSES) // STRIDE + 1  # 31
# 9d's store: the first 7 clips' windows (217), so that the FGD trainer
# takes 2 steps of 128 in 2 epochs and the K-fold trainer's fold 1 (train
# and val stores together, 434 windows) 3 steps in one epoch
SMALL_CLIPS = 7
STORE_BATCH = 128
SPEC_DB_TOL = 0.08  # dB, tests/test_preprocessing.py:116-160
EID_INDEX = (1, 65, 73, 81, 87, 95, 103, 111)  # one per _EID_BOUNDS range


def make_clip_store(path: Path, n_clips: int, seed: int = 0):
    """Clip records as the preprocessor reads them, from a numpy seed: no
    audio_feat (the spectrogram comes from audio_raw)."""
    rng = np.random.RandomState(seed)
    words = [f"word{k}" for k in range(STORE_WORDS)]
    n_frames = CLIP_S * CLIP_FPS
    t = np.arange(n_frames, dtype=np.float64)[:, None, None] / CLIP_FPS
    ts = np.arange(CLIP_S * M.SR) / M.SR
    with GestureStoreWriter(path) as w:
        for i in range(n_clips):
            rest = rng.randn(1, CLIP_JOINTS, 3) * 0.3
            freq = rng.uniform(0.3, 2.0, (1, CLIP_JOINTS, 3))
            phase = rng.uniform(0, 2 * np.pi, (1, CLIP_JOINTS, 3))
            skel = rest + 0.05 * np.sin(2 * np.pi * freq * t + phase)
            # speech-like: broadband noise in 4 Hz syllable bursts
            envelope = np.clip(np.sin(2 * np.pi * 4.0 * ts), 0, None) ** 2
            audio = rng.randn(len(ts)) * (0.05 + envelope)
            starts = np.arange(0.1, CLIP_S - 0.3, 0.3) \
                + rng.uniform(0, 0.05)
            eid = EID_INDEX[i % 8]
            w.append({
                "skeletons_3d": skel.astype(np.float32),
                "audio_raw": audio.astype(np.float32),
                "words": [[words[rng.randint(STORE_WORDS)], float(s),
                           float(s + 0.2)] for s in starts],
                "aux_info": {"vid": f"clip{i}",
                             "eid": f"1_speaker_0_{eid}_{eid}",
                             "start_frame_no": 0, "end_frame_no": n_frames,
                             "start_time": 0.0, "end_time": float(CLIP_S)},
            })


def preprocess(clips: Path, out: Path, frontend: str):
    pre = DataPreprocessor(clips, out, n_poses=N_POSES,
                           subdivision_stride=STRIDE,
                           pose_resampling_fps=CLIP_FPS,
                           spectrogram_frontend=frontend, device=DEVICE)
    reset_counts()
    t0 = time.perf_counter()
    _, n = pre.run()
    return n, time.perf_counter() - t0, FM.launches


def phase_preprocess(card, work: Path, counts):
    log(f"phase 9a: DataPreprocessor over a clip store of {STORE_CLIPS} "
        f"clips of {CLIP_S} s (16 kHz audio, {CLIP_JOINTS} joints at "
        f"{CLIP_FPS} fps, no audio_feat), n_poses {N_POSES}, stride "
        f"{STRIDE}: the 'pallas' frontend (the mel kernel) against 'xla' "
        "(its plain version)")
    clips = work / "clips"
    make_clip_store(clips, STORE_CLIPS)
    runs = {}
    for frontend, out in (("pallas", work / "beat" / "test_cache"),
                          ("xla", work / "xla" / "test_cache")):
        runs[frontend] = preprocess(clips, out, frontend)
    (n, wall, launches), (n_xla, wall_xla, launches_xla) = \
        runs["pallas"], runs["xla"]
    want = STORE_CLIPS * WINDOWS_PER_CLIP
    if n != want or n_xla != want:
        raise SystemExit(f"9a: {n} and {n_xla} windows (want {want})")
    if launches != STORE_CLIPS or launches_xla != 0:
        raise SystemExit(f"9a: mel launches {launches} and {launches_xla} "
                         f"(want one per clip, {STORE_CLIPS}, and 0)")
    counts["mel"] += launches
    kernel, plain = (GestureStore(work / "beat" / "test_cache"),
                     GestureStore(work / "xla" / "test_cache"))
    err = 0.0
    for i in range(n):
        a, b = kernel[i], plain[i]
        diff = np.abs(a.pop("spectrogram").astype(np.float32)
                      - b.pop("spectrogram").astype(np.float32)).max()
        err = max(err, float(diff))
        if diff > SPEC_DB_TOL or a.keys() != b.keys() or any(
                not np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
                else a[k] != b[k] for k in a):
            raise SystemExit(f"9a: window {i} differs between the frontends "
                             f"(spectrogram {diff:.4f} dB, atol "
                             f"{SPEC_DB_TOL})")
    plain.close()
    shutil.rmtree(work / "xla")
    size = kernel.offsets[-1]
    kernel.close()  # the clip store stays for phase 11a
    log(f"  [{card}] {n} windows ({size / 1e6:.1f} MB) from each frontend; "
        f"spectrograms within {err:.4f} dB (atol {SPEC_DB_TOL}), every other "
        f"field equal; mel launches {launches} = one per clip")
    log(f"  [{card}] preprocessing wall: 'pallas' {wall:.2f} s, 'xla' "
        f"{wall_xla:.2f} s ({STORE_CLIPS} clips, host window arithmetic and "
        "store writes included)")
    return {"windows": n, "bytes": int(size), "spec_max_abs_db": err,
            "mel_launches": launches, "wall_s": {"pallas": wall,
                                                 "xla": wall_xla}}


def phase_store_eval(card, work: Path, counts, synthetic):
    log(f"phase 9b: eval CLI main on the store, --test_batch_size {BATCH} "
        "--preset fast --num_diversity_passes 2 (no --synthetic)")
    data = work / "beat" / "test"
    args = eval_cli.build_parser().parse_args([
        "--test_data_path", str(data), "--test_batch_size", str(BATCH),
        "--preset", "fast", "--num_diversity_passes", "2", "--device",
        DEVICE, "--log_save_path", str(work / "eval_logs")])
    reset_counts()
    dataset_mod.native_batches = dataset_mod.exact_batches = 0
    summary = eval_cli.main(args)
    n_attn = FA.launches
    timings = summary["timings"]
    calls = timings["eval_batch_calls"]
    batches = (STORE_CLIPS * WINDOWS_PER_CLIP) // BATCH
    bad = [k for k in METRICS if not np.isfinite(summary[k])]
    if bad:
        raise SystemExit(f"9b: non-finite metrics {bad}")
    if calls != 2 * batches or n_attn != 6 * calls:
        raise SystemExit(f"9b: {calls} eval_batch calls (want "
                         f"{2 * batches}), attention launches {n_attn} "
                         f"(want {6 * calls})")
    native = (dataset_mod.native_batches, dataset_mod.exact_batches)
    if native != (batches, 0):
        raise SystemExit(f"9b: (native, exact) batches {native} (want "
                         f"({batches}, 0))")
    counts["fused_attention"] += n_attn
    vocab_path = data.parent / "vocab_all.pkl"
    store = GestureStore(str(data) + "_cache")
    scanned = build_vocab("words", [store])
    reloaded = Vocab.load(vocab_path)
    store.close()
    if reloaded.word2index != scanned.word2index or \
            reloaded.n_words != scanned.n_words:
        raise SystemExit("9b: vocab_all.pkl does not reload to the store's "
                         "vocabulary")
    ms = timings["eval_batch_ms"]
    ref = synthetic["timings"]
    log(f"  [{card}] store: " + ", ".join(
        f"{k} {summary[k]:.5f}" for k in METRICS))
    log(f"  [{card}] store: eval_batch {np.mean(ms[1:]):.1f} ms per call of "
        f"{BATCH} rows (CUDA events, calls 2-{calls}; all: "
        f"{', '.join(f'{v:.1f}' for v in ms)}); attention launches {n_attn} "
        f"= 6 x {calls}; {batches} batches, all through the native gather; "
        f"eval wall {timings['wall_s']:.2f} s, of which waiting for batches "
        f"{timings['data_wait_s']:.2f} s, beat {timings['beat_s']:.2f} s, "
        f"Frechet + diversity {timings['frechet_diversity_s']:.2f} s; "
        f"vocab_all.pkl reloads ({reloaded.n_words} words)")
    log(f"  [{card}] phase 5 (synthetic, same flags): eval_batch "
        f"{np.mean(ref['eval_batch_ms'][1:]):.1f} ms, wall "
        f"{ref['wall_s']:.2f} s, waiting for batches "
        f"{ref['data_wait_s']:.2f} s")
    out = {k: summary[k] for k in METRICS}
    out.update(timings=timings, n_words=reloaded.n_words,
               native_batches=native[0])
    return out


def trace_busy_share(trace_json: Path) -> float:
    """CUDA kernel time over the span from the first kernel's start to the
    last one's end, in a torch.profiler Chrome trace."""
    events = json.loads(trace_json.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    span = (max(e["ts"] + e["dur"] for e in kernels)
            - min(e["ts"] for e in kernels))
    return sum(e["dur"] for e in kernels) / span


def phase_store_train(card, work: Path, train, profiling=False):
    log(f"phase 9c: GAN trainer main on the store, --preset fast, batch "
        f"{STORE_BATCH}, one epoch, full width (no --synthetic)")
    trace_dir = work / "gan_store_trace"
    args = train_cli.build_parser().parse_args([
        "--train_data_path", str(work / "beat" / "test"), "--batch_size",
        str(STORE_BATCH), "--total_epoch", "1", "--preset", "fast",
        "--device", DEVICE, "--save_every", "1000", "--model_save_path",
        str(work / "gan_store"),
        *(["--profile_dir", str(trace_dir)] if profiling else [])])
    reset_counts()
    dataset_mod.native_batches = dataset_mod.exact_batches = 0
    torch.cuda.reset_peak_memory_stats()
    gen, disc, summary = train_cli.main(args)
    steps = (STORE_CLIPS * WINDOWS_PER_CLIP) // STORE_BATCH
    assert_no_launches("9c")
    bad = [k for k, v in summary["metrics"].items() if not np.isfinite(v)]
    if bad or (gen.step, disc.step) != (steps, steps):
        raise SystemExit(f"9c: steps {gen.step}, {disc.step} (want {steps}),"
                         f" non-finite losses {bad}")
    if (dataset_mod.native_batches, dataset_mod.exact_batches) != (steps, 0):
        raise SystemExit("9c: not every batch came through the native "
                         "gather")
    n_words = gen.module.text_encoder.embedding.num_embeddings
    del gen, disc
    shutil.rmtree(work / "gan_store")
    res = trainer_numbers(summary["step_ms"], STORE_BATCH,
                          torch.cuda.max_memory_allocated(), summary["wall_s"])
    res.update(losses=summary["metrics"], n_words=n_words)
    busy = ""
    if profiling:
        res["busy_share"] = trace_busy_share(trace_dir / "trace.json")
        busy = (f", device busy share {res['busy_share']:.3f} over the "
                "traced steps 4-8 (torch.profiler, prefetcher running)")
    log(f"  [{card}] store, bf16 g_first, {n_words} words: "
        f"{res['ms_per_step']:.2f} ms per step (CUDA events, steps "
        f"3-{steps}; all: {', '.join(f'{v:.2f}' for v in res['step_ms'])})"
        f", {res['samples_per_s']:.1f} samples/s, peak "
        f"{res['peak_bytes'] / 2**30:.2f} GiB allocated, wall "
        f"{res['wall_s']:.1f} s{busy}; last losses " + ", ".join(
            f"{k} {v:.5f}" for k, v in res["losses"].items())
        + f"; {steps} batches through the native gather; attention, mel "
        "and SE-stage launches 0")
    ref = train["fast"]
    log(f"  [{card}] phase 6b (synthetic, same flags): "
        f"{ref['ms_per_step']:.2f} ms per step, "
        f"{ref['samples_per_s']:.1f} samples/s, wall {ref['wall_s']:.1f} s")
    return res


def phase_store_aux(card, work: Path):
    small = work / "small" / "test"
    big = GestureStore(work / "beat" / "test_cache")
    n_small = SMALL_CLIPS * WINDOWS_PER_CLIP
    with GestureStoreWriter(str(small) + "_cache") as w:
        for i in range(n_small):
            w.append(big[i])
    big.close()
    log(f"phase 9d: FGD trainer (2 epochs) and the K-fold trainer "
        f"(--max_folds 1, one epoch) on the first {n_small} windows of the "
        f"store as train, val and test, batch {STORE_BATCH}")
    args = aux_cli.build_parser().parse_args([
        "--model", "fgd", "--train_data_path", str(small), "--batch_size",
        str(STORE_BATCH), "--total_epoch", "2", "--device", DEVICE,
        "--save_every", "1000", "--model_save_path", str(work / "aux_store")])
    reset_counts()
    state, summary = aux_cli.main(args)
    assert_no_launches("9d fgd")
    fgd_loss = summary["metrics"]["loss"]
    if state.step != 2 or not np.isfinite(fgd_loss):
        raise SystemExit(f"9d fgd: step {state.step}, loss {fgd_loss}")
    args = kfold_cli.build_parser().parse_args([
        "--train_data_path", str(small), "--val_data_path", str(small),
        "--test_data_path", str(small), "--batch_size", str(STORE_BATCH),
        "--total_epoch", "1", "--max_folds", "1", "--device", DEVICE,
        "--model_save_path", str(work / "kfold_store")])
    reset_counts()
    step, seen = classifier.train_step, []

    def spy(*a, **k):  # the losses of the K-fold loop's steps
        state, metrics = step(*a, **k)
        seen.append(metrics["loss"])
        return state, metrics

    classifier.train_step = spy
    try:
        results = kfold_cli.main(args)
    finally:
        classifier.train_step = step
    assert_no_launches("9d K-fold")
    # fold 1's train split of the train and val stores together
    want = (2 * n_small - (2 * n_small + 9) // 10) // STORE_BATCH
    losses = [float(m) for m in seen]
    r = results[0] if results else None
    if r is None or r["state"].step != want or len(losses) != want or \
            not np.all(np.isfinite(losses)) or not np.isfinite(r["test_acc"]):
        raise SystemExit(f"9d K-fold: results {results}, losses {losses} "
                         f"(want {want} steps)")
    shutil.rmtree(work / "kfold_store")
    log(f"  [{card}] fgd: 2 steps, loss {fgd_loss:.5f}, step ms "
        f"{', '.join(f'{v:.2f}' for v in summary['step_ms'])}; K-fold "
        f"fp32: {want} steps, losses {', '.join(f'{v:.5f}' for v in losses)}"
        f", test "
        f"accuracy {r['test_acc']:.2f}%, step ms "
        f"{', '.join(f'{v:.2f}' for v in r['step_ms'])}; attention, mel and "
        "SE-stage launches 0")
    return {"fgd_loss": fgd_loss, "kfold_loss": losses[-1],
            "kfold_steps": want, "kfold_test_acc": r["test_acc"]}


def phase_store(card, work: Path, counts, synthetic_eval, train,
                profiling=False):
    return {"preprocess": phase_preprocess(card, work, counts),
            "eval": phase_store_eval(card, work, counts, synthetic_eval),
            "train": phase_store_train(card, work, train, profiling),
            "aux": phase_store_aux(card, work)}


# ---------------------------------------------------------------------------
# phase 10: data parallelism, two ranks on the one card
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_STEPS = 2
DP_TIMEOUT = 900  # seconds for the two ranks of phase 10 together
# 10a, tests/test_parallel.py:113-142: step-0 losses within rtol 2e-4 (atol
# 1e-5), step-1 within 5e-3; after the steps every parameter and running
# statistic within 5e-3, at most 0.1% of elements beyond 2 * (2 * lr). bf16
# (bf16 products of 64 rows where one process has 128): step-0 losses 5e-4
# and states 1e-2, about three times the reading on an H100 80GB HBM3 at
# 700 W (1.38e-4 and 3.68e-3; step 1 3.5e-4, 0.015% of elements beyond)
DP_TOL = {"float32": ((2e-4, 5e-3), 5e-3),
          "bfloat16": ((5e-4, 5e-3), 1e-2)}
# 10b, the ranks' eval_batch against one process: fp32 (parity) within
# phase 4's POSE_TOL; bf16 (fast) FGD features within POSE_TOL and poses
# within 1.5e-4, three times the reading on an H100 80GB HBM3 at 700 W
# (5.08e-5): the bf16 convolutions and products of 512 rows round otherwise
# than those of 1024 (the same reading with TMMemory's coupling computed
# from gathered rows, as one process computes it; fp32 reads 9.1e-7)
DP_EVAL_TOL = {"parity": (POSE_TOL["float32"], POSE_TOL["float32"]),
               "fast": (dict(rtol=0.0, atol=1.5e-4), POSE_TOL["bfloat16"])}
# and TMMemory's output, which the coupling moves first: fp32 within
# POSE_TOL, bf16 within 5e-3, about three times the reading (1.47e-3, the
# rounding of bf16 outputs). TMMemory's scores grow with the rows coupled
# and its softmax is saturated at 1024 (and 512) rows, so coupling per rank
# moves its output by only 3.3e-5 in fp32 (the poses by less than 1e-7):
# the fp32 check catches that fault, the bf16 one cannot resolve it
DP_TM_TOL = {"parity": POSE_TOL["float32"],
             "fast": dict(rtol=0.0, atol=5e-3)}


def dp_local(batch: dict) -> dict:
    rows = distributed.process_batch_slice(len(batch["pose_seq"]))
    return {k: v[rows].cuda() for k, v in batch.items()}


def dp_gan_steps(fields, batch, broadcast=True):
    """DP_STEPS GAN train steps at full width on `batch` (this rank's rows,
    or the global batch under mesh.single_process()): the states, each
    step's losses and ms (CUDA events)."""
    cfg = gan.GANConfig(**fields)
    gs, ds = gan.create_states(cfg, 0, device="cuda")
    if broadcast:
        distributed.broadcast_module(gs.module)
        distributed.broadcast_module(ds.module)
    metrics, ms = [], []
    for i in range(DP_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        gs, ds, m = gan.train_step(gs, ds, batch, 1 + i, cfg)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
        metrics.append({k: float(v) for k, v in m.items()})
    return cfg, gs, ds, metrics, ms


def dp_errors(ref, got, tol):
    """The worst readings of tests/test_parallel.py's criteria between a
    one-process run and rank 0's, and the list of violations."""
    (loss_tol, state_tol), bad = tol, []
    cfg, g0, d0, m0, _ = ref
    _, g1, d1, m1, _ = got
    rel = []
    for step, rtol in enumerate(loss_tol):
        worst = 0.0
        for k, a in m0[step].items():
            b = m1[step][k]
            worst = max(worst, abs(a - b) / max(abs(a), 1e-30))
            if abs(a - b) > 1e-5 + rtol * abs(a):
                bad.append(f"step {step} {k}: {a} vs {b}")
        rel.append(worst)
    quantum = DP_STEPS * 2 * cfg.lr
    state_max, n_out, n_tot = 0.0, 0, 0
    for net, (s0, s1) in {"G": (g0, g1), "D": (d0, d1)}.items():
        sd1 = s1.module.state_dict()
        for name, want in s0.module.state_dict().items():
            diff = (sd1[name].double() - want.double()).abs()
            state_max = max(state_max, float(diff.max()))
            if float(diff.max()) >= state_tol:
                bad.append(f"{net} {name}: {float(diff.max()):.3e}")
            n_out += int((diff > quantum).sum())
            n_tot += diff.numel()
    if n_out > max(1, n_tot // 1000):
        bad.append(f"{n_out} of {n_tot} elements beyond {quantum:.1e}")
    return {"loss_rel": rel, "state_max_abs_err": state_max,
            "outliers": n_out, "elements": n_tot, "bad": bad}


def local_moments(x32, dims):
    """10a's planted fault: BatchNorm on this rank's statistics."""
    return x32.mean(dims), (x32 * x32).mean(dims)


def local_coupling(mem, pe):
    """10b's planted fault: TMMemory coupling this rank's rows only."""
    return mem.T @ pe


def dp_train_rank():
    """10a in one rank: per preset, the one-process run of the global batch
    (rank 0, the other rank waiting), the two ranks' run, and for fp32 the
    run with per-rank BatchNorm statistics."""
    fp32_exact_on_cuda()
    batch = train_batch(TRAIN_BATCH)
    full, local = {k: v.cuda() for k, v in batch.items()}, dp_local(batch)
    primary = distributed.is_primary()
    out = {}
    for name, (_, fields) in TRAIN_RUNS.items():
        tol = DP_TOL[fields["compute_dtype"]]
        ref = None
        if primary:
            with mesh.single_process():
                ref = dp_gan_steps(fields, full, broadcast=False)
        distributed.barrier()
        got = dp_gan_steps(fields, local)
        res = {"ms": got[4], "losses": got[3][-1]}
        if primary:
            res.update(dp_errors(ref, got, tol))
        del got
        if name == "fp32":
            honest = L.batch_moments
            L.batch_moments = local_moments
            try:
                faulty = dp_gan_steps(fields, local)
            finally:
                L.batch_moments = honest
            if primary:
                res["fault"] = dp_errors(ref, faulty, tol)
            del faulty
        del ref
        torch.cuda.empty_cache()
        out[name] = res
    return out


DP_EVAL_FIELDS = ("spectrogram", "text", "pose_seq", "eid_label")


def dp_eval_rank():
    """10b in one rank, per preset: eval_batch at full width on the global
    batch (rank 0 alone) and on this rank's rows, the ranks' outputs
    gathered; then with TMMemory coupling per rank. `--preset fast` also
    counts the attention launches and times the call."""
    raw = next(SyntheticGestureDataset(n_samples=BATCH, seed=4).batches(
        BATCH, shuffle=False, fields=DP_EVAL_FIELDS))
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    batch["noise"] = torch.randn(BATCH, 32,
                                 generator=torch.Generator().manual_seed(8))
    local = dp_local(batch)
    inputs = [local[k] for k in DP_EVAL_FIELDS]
    primary = distributed.is_primary()
    out = {}
    for preset, (pose_tol, feat_tol) in DP_EVAL_TOL.items():
        args = eval_cli.build_parser().parse_args(["--device", "cuda",
                                                   "--preset", preset])
        eval_cli.apply_preset(args, eval_cli.build_parser(),
                              eval_cli.EVAL_FAST)
        nets = eval_cli.build_models(args, eval_cli.N_WORDS_SYNTHETIC,
                                     torch.device("cuda"))
        tm_out = []
        tm = nets.gen.prior_seq_encoder.temporal_memory
        hook = tm.register_forward_hook(lambda m, a, out: tm_out.append(out))
        ref = None
        if primary:
            with mesh.single_process():
                ref = eval_cli.eval_batch(
                    nets, *[batch[k].cuda() for k in DP_EVAL_FIELDS],
                    noise=batch["noise"].cuda())
            ref = (ref[0], ref[2], tm_out.pop())
        distributed.barrier()

        def gathered():
            o = eval_cli.eval_batch(nets, *inputs, noise=local["noise"])
            return [mesh.all_gather(t) for t in (o[0], o[2], tm_out[-1])]

        reset_counts()
        got = gathered()
        res = {"launches_first_call": FA.launches, "ms": []}
        for _ in range(3 if preset == "fast" else 0):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            eval_cli.eval_batch(nets, *inputs, noise=local["noise"])
            stop.record()
            torch.cuda.synchronize()
            res["ms"].append(start.elapsed_time(stop))
        res.update(launches=FA.launches, calls=1 + len(res["ms"]))
        honest = gen_mod.batch_coupling
        gen_mod.batch_coupling = local_coupling
        try:
            faulty = gathered()
        finally:
            gen_mod.batch_coupling = honest
        hook.remove()
        if primary:
            for tag, outs in (("errors", got), ("fault_errors", faulty)):
                res[tag] = {
                    name: (float((a.float() - b.float()).abs().max()),
                           bool(torch.allclose(a.float(), b.float(), **tol)))
                    for name, a, b, tol in zip(
                        ("poses", "FGD features", "TMMemory output"), outs,
                        ref, (pose_tol, feat_tol, DP_TM_TOL[preset]))}
        del nets, ref, got, faulty, tm_out
        torch.cuda.empty_cache()
        out[preset] = res
    return out


def dp_cli_rank(work: str):
    """10c in one rank: the GAN trainer's main (--preset fast, 2 epochs,
    then --resume for one) and the eval CLI's main (phase 5's fast run)
    in the group this rank is in."""
    work = Path(work)
    model_dir = work / "dp_gan"
    flags = ["--synthetic", str(TRAIN_SAMPLES), "--batch_size",
             str(TRAIN_BATCH), "--device", "cuda", "--save_every", "1000",
             "--preset", "fast", "--model_save_path", str(model_dir)]
    reset_counts()
    gs, ds, first = train_cli.main(train_cli.build_parser().parse_args(
        flags + ["--total_epoch", "2"]))
    steps = [(gs.step, ds.step)]
    del gs, ds
    gs, ds, resumed = train_cli.main(train_cli.build_parser().parse_args(
        flags + ["--total_epoch", "1", "--resume"]))
    steps.append((gs.step, ds.step))
    train_launches = (FA.launches, FM.launches, FS.launches)
    del gs, ds
    torch.cuda.empty_cache()
    args = eval_cli.build_parser().parse_args([
        "--synthetic", str(EVAL_SAMPLES), "--test_batch_size", str(BATCH),
        "--device", "cuda", "--log_save_path", str(work / "dp_eval"),
        *EVAL_RUNS["fast"]])
    reset_counts()
    summary = eval_cli.main(args)
    return {"steps": steps, "train": [first, resumed],
            "train_launches": train_launches, "eval": summary,
            "eval_launches": FA.launches}


def phase_dp(card, work: Path, counts, evals):
    """Phase 10: two ranks on the one card (gloo; NCCL refuses two ranks on
    one device), spawned, against one process. The ranks time-slice the
    card: their times are no scaling figure. They are fresh interpreters
    (the `spawn` start method), so nothing of this process's CUDA state
    from phases 1-9 reaches them; its cached memory is released first."""
    torch.cuda.empty_cache()
    log(f"phase 10: data parallelism, {DP_RANKS} ranks on cuda:0 over gloo "
        "(spawned; two processes time-slicing one card, not a scaling "
        "figure)")
    t0 = time.perf_counter()
    ranks = mesh.launch(dp_all_rank, DP_RANKS, str(work), device="cuda",
                        backend="gloo", timeout=DP_TIMEOUT)
    wall = time.perf_counter() - t0
    result = {"wall_s": wall}
    # 10a
    for name, (extra, fields) in TRAIN_RUNS.items():
        r0 = ranks[0]["train"][name]
        log(f"phase 10a ({name}): GAN train_step x {DP_STEPS}, full width, "
            f"global batch {TRAIN_BATCH} ({TRAIN_BATCH // DP_RANKS} per "
            f"rank), dropout on, {' '.join(extra)}: losses rel err "
            + ", ".join(f"step {i} {v:.3e}" for i, v in
                        enumerate(r0["loss_rel"]))
            + f"; states max_abs_err {r0['state_max_abs_err']:.3e}, "
            f"{r0['outliers']} of {r0['elements']} elements beyond "
            f"2 * (2 * lr) ({'ok' if not r0['bad'] else 'FAIL'})")
        log(f"  [{card}] {name}: ms per step per rank (CUDA events, two "
            "ranks on one card): " + "; ".join(
                f"rank {i} " + ", ".join(f"{t:.1f}" for t in
                                         r["train"][name]["ms"])
                for i, r in enumerate(ranks)))
        if r0["bad"]:
            raise SystemExit(f"10a {name}: two ranks disagree with one "
                             f"process: {r0['bad'][:5]}")
        if name == "fp32":
            f = r0["fault"]
            caught = bool(f["bad"])
            log(f"  planted fault (BatchNorm on per-rank statistics): losses "
                f"rel err step 0 {f['loss_rel'][0]:.3e}, states "
                f"max_abs_err {f['state_max_abs_err']:.3e}, "
                f"{len(f['bad'])} violations, "
                f"{'caught' if caught else 'MISSED'}")
            if not caught:
                raise SystemExit("10a: the parity check misses per-rank "
                                 "BatchNorm statistics")
        result[f"train_{name}"] = {k: v for k, v in r0.items()
                                   if k != "fault"}
    # 10b
    for preset, (pose_tol, feat_tol) in DP_EVAL_TOL.items():
        e0 = ranks[0]["eval"][preset]
        log(f"phase 10b ({preset}): eval_batch, full width, global batch "
            f"{BATCH} ({BATCH // DP_RANKS} per rank), against one process "
            f"(poses atol {pose_tol['atol']}, FGD features atol "
            f"{feat_tol['atol']}, TMMemory output atol "
            f"{DP_TM_TOL[preset]['atol']}): " + ", ".join(
                f"{k} max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}"
                for k, (err, ok) in e0["errors"].items()))
        want = 6 if preset == "fast" else 0
        for i, r in enumerate(ranks):
            e = r["eval"][preset]
            if preset == "fast":
                log(f"  [{card}] rank {i}: attention launches "
                    f"{e['launches_first_call']} in one eval_batch, "
                    f"{e['launches']} in {e['calls']}; eval_batch ms (CUDA "
                    "events, two ranks on one card): "
                    + ", ".join(f"{t:.1f}" for t in e["ms"]))
            if e["launches_first_call"] != want or \
                    e["launches"] != want * e["calls"]:
                raise SystemExit(f"10b {preset} rank {i}: {e['launches']} "
                                 f"attention launches in {e['calls']} "
                                 "eval_batch calls")
            counts["fused_attention"] += e["launches"]
        if not all(ok for _, ok in e0["errors"].values()):
            raise SystemExit(f"10b {preset}: two ranks disagree with one "
                             "process")
        caught = not all(ok for _, ok in e0["fault_errors"].values())
        log("  planted fault (TMMemory coupling per rank): " + ", ".join(
            f"{k} max_abs_err {err:.3e}" for k, (err, _) in
            e0["fault_errors"].items())
            + (f", {'caught' if caught else 'MISSED'}" if preset == "parity"
               else f", {'caught' if caught else 'not caught'} (not "
               "required: below bf16's resolution of that output, see "
               "DP_TM_TOL; the fp32 check holds it)"))
        if preset == "parity" and not caught:
            raise SystemExit("10b: the parity check misses per-rank "
                             "TMMemory")
        result[f"eval_batch_{preset}"] = e0
    # 10c
    c = [r["cli"] for r in ranks]
    want = [(2 * EPOCH_STEPS,) * 2, (3 * EPOCH_STEPS,) * 2]
    for i, r in enumerate(c):
        if [tuple(s) for s in r["steps"]] != want:
            raise SystemExit(f"10c rank {i}: steps {r['steps']}, want {want}")
        if r["train_launches"] != (0, 0, 0):
            raise SystemExit(f"10c rank {i}: kernel launches in training "
                             f"{r['train_launches']}")
        bad = [k for s in r["train"] for k, v in s["metrics"].items()
               if not np.isfinite(v)]
        if bad:
            raise SystemExit(f"10c rank {i}: non-finite losses {bad}")
    log_text = (work / "dp_gan" / "train_emotion_gesture.log").read_text()
    files = sorted(p.name for p in (work / "dp_gan" / "generator").iterdir())
    if log_text.count("done:") != 2 or "[rank 1" in log_text or \
            "checkpoint_iteration12.pt" not in files:
        raise SystemExit(f"10c: the log or the checkpoints are not rank "
                         f"0's alone ({files})")
    log(f"phase 10c: GAN trainer main, --preset fast, {TRAIN_SAMPLES} "
        f"samples, global batch {TRAIN_BATCH}, 2 epochs then --resume: "
        f"steps {want[0]} -> {want[1]} for G and D on both ranks; one "
        f"log and the checkpoints ({', '.join(files)}) from rank 0; last "
        f"losses " + ", ".join(f"{k} {v:.5f}" for k, v in
                               c[0]["train"][1]["metrics"].items()))
    for i, r in enumerate(c):
        first = r["train"][0]
        steady = first["step_ms"][2:]
        log(f"  [{card}] rank {i}: {np.mean(steady):.2f} ms per step, "
            f"median {np.median(steady):.2f} (CUDA events, steps 3-8; all: "
            + ", ".join(f"{t:.1f}" for t in first["step_ms"])
            + f"), wall {first['wall_s']:.1f} s + "
            f"{r['train'][1]['wall_s']:.1f} s")
    ev, one = c[0]["eval"], evals["fast"]
    rel = {k: abs(ev[k] - one[k]) / max(abs(one[k]), 1e-30)
           for k in METRICS}
    log("phase 10c: eval CLI main, --preset fast, --synthetic "
        f"{EVAL_SAMPLES}, batches of {BATCH}, 2 diversity passes, against "
        "phase 5's one-process run: " + ", ".join(
            f"{k} {ev[k]:.5f} vs {one[k]:.5f} (rel {rel[k]:.2e})"
            for k in METRICS))
    calls = EVAL_SAMPLES // BATCH * 2
    for i, r in enumerate(c):
        t = r["eval"]["timings"]
        log(f"  [{card}] rank {i}: attention launches {r['eval_launches']}"
            f" = 6 x {t['eval_batch_calls']} eval_batch calls; eval_batch "
            + ", ".join(f"{x:.1f}" for x in t["eval_batch_ms"])
            + f" ms (CUDA events, {BATCH // DP_RANKS} rows); eval wall "
            f"{t['wall_s']:.2f} s")
        if t["eval_batch_calls"] != calls or \
                r["eval_launches"] != 6 * calls:
            raise SystemExit(f"10c rank {i}: {r['eval_launches']} launches "
                             f"in {t['eval_batch_calls']} calls")
        counts["fused_attention"] += r["eval_launches"]
    bad = [k for k in METRICS if rel[k] > DP_EVAL_REL[k]]
    if bad:
        raise SystemExit(f"10c: the eval's metrics on two ranks differ from "
                         f"one process: {bad}")
    result["cli"] = {"eval_rel": rel, "train_ms": [
        r["train"][0]["step_ms"] for r in c],
        "eval_batch_ms": [r["eval"]["timings"]["eval_batch_ms"] for r in c]}
    if torch.cuda.device_count() >= 2:
        log("phase 10c: GAN trainer --num_devices 2 over NCCL")
        _, _, s = train_cli.main(train_cli.build_parser().parse_args([
            "--synthetic", str(TRAIN_SAMPLES), "--batch_size",
            str(TRAIN_BATCH), "--device", "cuda", "--save_every", "1000",
            "--total_epoch", "1", "--num_devices", "2", "--model_save_path",
            str(work / "nccl_gan")]))
        if s["steps"] != EPOCH_STEPS or s["ranks"] != 2:
            raise SystemExit(f"10c NCCL: {s['steps']} steps")
        log(f"  [{card}] NCCL, 2 cards: {np.mean(s['step_ms'][2:]):.2f} ms "
            "per step")
    else:
        log("phase 10c: the NCCL run (--num_devices 2) needs a second card; "
            f"this machine has {torch.cuda.device_count()}")
    log(f"  [{card}] phase 10 wall {wall:.1f} s (spawn, both ranks, all "
        "of 10a-10c)")
    return result


# 10c: the eval CLI's metrics on two ranks against phase 5's one process,
# relative: the tolerances of tests/test_torch_port_eval.py (l2, mpjre,
# diversity 1e-5; FGD 1e-4; beat 1e-3 of its value; the largest reading on
# an H100 80GB HBM3 at 700 W, bf16: 2.6e-6), Emotion-Acc within one sample
# in 2048
DP_EVAL_REL = {"l2": 1e-5, "mpjre_deg": 1e-5, "fgd": 1e-4, "beat": 1e-3,
               "emotion_acc": 1.0 / EVAL_SAMPLES, "diversity": 1e-5}


def dp_all_rank(work: str):
    out = {"train": dp_train_rank()}
    torch.cuda.empty_cache()
    out["eval"] = dp_eval_rank()
    torch.cuda.empty_cache()
    out["cli"] = dp_cli_rank(work)
    return out


# ---------------------------------------------------------------------------
# phase 11: the data-migration path, reference LMDBs -> GestureStores
# ---------------------------------------------------------------------------

# a TED-layout cache: windows of 34 frames (10 joints, 9 dir-vecs), 36267
# audio samples, (128, 70) spectrograms (lmdb_data_loader.py:104-113)
TED_WINDOWS = 300
# the eval's metrics on the converted store against 9b's, relative
MIGRATED_EVAL_REL = 1e-6
# BeatAlignerV1's batch score over 2108 windows, the card's onset frontend
# (fp32 DFT) against the host's (fp64), absolute. The first reading on an
# H100 80GB HBM3 at 700 W was 0 (the same onsets in every window); one
# onset moved in one window moves the mean by at most ~1/2108 ~ 5e-4, so
# this admits a rounding tie or two and fails a frontend fault that moves
# onsets across the batch
BEAT_FRONTEND_TOL = 1e-3


def write_lmdb(path: Path, items: dict) -> Path:
    """The LMDB writer of tests/fixtures/make_lmdb_fixture.py (the mdb.c
    spec, imports neither package); the port itself writes no LMDB."""
    sys.path.insert(0, str(REPO / "tests" / "fixtures"))
    try:
        from make_lmdb_fixture import write_lmdb as write
    finally:
        sys.path.pop(0)
    return write(path, items)


def lmdb_line(path: Path) -> str:
    with LmdbEnv(path) as env:
        size = env.path.stat().st_size
        return (f"{len(env)} entries, {size / 1e6:.1f} MB, depth "
                f"{env.depth}"), size


def convert(command: str, src: Path, out: Path, what: str):
    """convert_data's main on one LMDB: (records, wall s)."""
    t0 = time.perf_counter()
    n = convert_cli.main(convert_cli.build_parser().parse_args(
        [command, "--lmdb", str(src), "--out", str(out)]))
    wall = time.perf_counter() - t0
    size = (src / "data.mdb").stat().st_size
    log(f"  convert_data {command} ({what}): {n} records in {wall:.2f} s, "
        f"{n / wall:.1f} records/s, {size / 1e6 / wall:.1f} MB/s of LMDB")
    return n, wall


def same_values(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return a == b


def first_difference(got: Path, want: Path):
    """None if two stores hold the same records field for field, else
    (record, field)."""
    a, b = GestureStore(got), GestureStore(want)
    try:
        if len(a) != len(b):
            return ("count", len(a), len(b))
        for i in range(len(a)):
            ra, rb = a[i], b[i]
            if ra.keys() != rb.keys():
                return (i, "keys")
            for k in ra:
                if not same_values(ra[k], rb[k]):
                    return (i, k)
        return None
    finally:
        a.close()
        b.close()


def same_store_bytes(got: Path, want: Path) -> bool:
    return all((got / f).read_bytes() == (want / f).read_bytes()
               for f in ("index.npy", "data.bin"))


def phase_migrate_clips(card, work: Path, counts):
    """11a: 9a's clip store -> a raw clip LMDB -> convert_data clips ->
    DataPreprocessor ('pallas') -> 9a's windows."""
    log(f"phase 11a: a raw clip LMDB of 9a's {STORE_CLIPS} clips (one video "
        "per record, its clip nested, a seeded float16 audio_feat each) -> "
        "convert_data clips -> DataPreprocessor 'pallas'")
    rng = np.random.RandomState(11)
    src = GestureStore(work / "clips")
    n_feat = 1 + CLIP_S * M.SR // 512
    t0 = time.perf_counter()
    items, clips = {}, []
    for i in range(len(src)):
        rec = src[i]
        aux = rec["aux_info"]
        clip = {"skeletons_3d": rec["skeletons_3d"],
                "audio_feat": rng.randn(128, n_feat).astype(np.float16),
                "audio_raw": rec["audio_raw"], "words": rec["words"],
                "eid": aux["eid"], "start_frame_no": aux["start_frame_no"],
                "end_frame_no": aux["end_frame_no"],
                "start_time": aux["start_time"], "end_time": aux["end_time"]}
        clips.append((clip, aux))
        items[f"{i:010d}".encode()] = arrow014.serialize(
            {"vid": aux["vid"], "clips": [clip]})
    ser_s = time.perf_counter() - t0
    lmdb = write_lmdb(work / "clips_lmdb", items)
    write_s = time.perf_counter() - t0 - ser_s
    del items
    desc, size = lmdb_line(lmdb)
    log(f"  clip LMDB: {desc}; arrow014.serialize {ser_s:.2f} s "
        f"({len(clips) / ser_s:.1f} videos/s), LMDB write {write_s:.2f} s")
    n, conv_s = convert("clips", lmdb, work / "clips_conv", "raw clips")
    got = GestureStore(work / "clips_conv")
    if n != STORE_CLIPS or len(got) != STORE_CLIPS:
        raise SystemExit(f"11a: {n} clip records (want {STORE_CLIPS})")
    for i, (clip, aux) in enumerate(clips):
        rec = got[i]
        want = {"skeletons_3d": clip["skeletons_3d"],
                "audio_feat": clip["audio_feat"],
                "audio_raw": clip["audio_raw"], "words": clip["words"],
                "aux_info": aux}
        if rec.keys() != want.keys() or not all(
                same_values(rec[k], want[k]) for k in want):
            raise SystemExit(f"11a: converted clip {i} differs from its "
                             "source")
    got.close()
    src.close()
    shutil.rmtree(lmdb)
    n_win, wall, launches = preprocess(work / "clips_conv",
                                       work / "conv_clips" / "test_cache",
                                       "pallas")
    want = STORE_CLIPS * WINDOWS_PER_CLIP
    if n_win != want or launches != STORE_CLIPS:
        raise SystemExit(f"11a: {n_win} windows (want {want}), mel launches "
                         f"{launches} (want {STORE_CLIPS})")
    counts["mel"] += launches
    mine, ref = work / "conv_clips" / "test_cache", work / "beat" / \
        "test_cache"
    diff = None if same_store_bytes(mine, ref) else \
        first_difference(mine, ref)
    if diff is not None:
        raise SystemExit(f"11a: windows differ from 9a's at {diff}")
    shutil.rmtree(work / "conv_clips")
    shutil.rmtree(work / "clips_conv")
    shutil.rmtree(work / "clips")
    log(f"  [{card}] every clip field equals its source; {n_win} windows "
        f"equal to 9a's 'pallas' windows byte for byte (data.bin, "
        f"index.npy); mel launches {launches} = one per clip; "
        f"preprocessing wall {wall:.2f} s")
    return {"lmdb_bytes": int(size), "serialize_s": ser_s,
            "lmdb_write_s": write_s, "convert_s": conv_s,
            "preprocess_s": wall, "windows": n_win, "mel_launches": launches}


def phase_migrate_windows(card, work: Path, counts, store_eval):
    """11b: 9a's windows -> a BEAT-layout cache LMDB -> convert_data cache
    -> 9a's store bytes -> the eval CLI as in 9b; a TED-layout cache."""
    log(f"phase 11b: a BEAT-layout cache LMDB (5-tuples) of 9a's "
        f"{STORE_CLIPS * WINDOWS_PER_CLIP} windows -> convert_data cache -> "
        "the eval CLI with 9b's flags")
    ref = work / "beat" / "test_cache"
    windows = GestureStore(ref)
    t0 = time.perf_counter()
    items = {}
    for i in range(len(windows)):
        r = windows[i]
        items[f"{i:010d}".encode()] = arrow014.serialize(
            [r["word_seq"], r["pose_seq"], r["audio"], r["spectrogram"],
             r["aux_info"]])
    ser_s = time.perf_counter() - t0
    lmdb = write_lmdb(work / "beat_lmdb", items)
    write_s = time.perf_counter() - t0 - ser_s
    n_items = len(items)
    del items
    windows.close()
    desc, size = lmdb_line(lmdb)
    log(f"  BEAT cache LMDB: {desc}; arrow014.serialize {ser_s:.2f} s "
        f"({n_items / ser_s:.1f} windows/s), LMDB write {write_s:.2f} s")
    conv = work / "migrated" / "test_cache"
    n, conv_s = convert("cache", lmdb, conv, "BEAT windows")
    shutil.rmtree(lmdb)
    if n != n_items:
        raise SystemExit(f"11b: {n} records (want {n_items})")
    if not same_store_bytes(conv, ref):
        diff = first_difference(conv, ref) or "bytes only, fields equal"
        raise SystemExit(f"11b: the converted store differs from 9a's: "
                         f"{diff}")
    log(f"  [{card}] the converted store equals 9a's byte for byte "
        f"(data.bin {conv.joinpath('data.bin').stat().st_size / 1e6:.1f} MB,"
        " index.npy)")

    args = eval_cli.build_parser().parse_args([
        "--test_data_path", str(work / "migrated" / "test"),
        "--test_batch_size", str(BATCH), "--preset", "fast",
        "--num_diversity_passes", "2", "--device", DEVICE,
        "--log_save_path", str(work / "eval_logs_migrated")])
    reset_counts()
    summary = eval_cli.main(args)
    n_attn = FA.launches
    calls = summary["timings"]["eval_batch_calls"]
    rel = {k: abs(summary[k] - store_eval[k]) / max(abs(store_eval[k]),
                                                     1e-30)
           for k in METRICS}
    worst = max(rel.values())
    if n_attn != 6 * calls or calls != store_eval["timings"][
            "eval_batch_calls"]:
        raise SystemExit(f"11b: {calls} eval_batch calls, attention "
                         f"launches {n_attn} (want 6 per call)")
    if worst > MIGRATED_EVAL_REL:
        raise SystemExit(f"11b: metrics differ from 9b's: {rel}")
    counts["fused_attention"] += n_attn
    log(f"  [{card}] eval on the converted store: " + ", ".join(
        f"{k} {summary[k]:.5f}" for k in METRICS)
        + f"; largest relative difference from 9b's {worst:.3e} "
        f"(limit {MIGRATED_EVAL_REL}); attention launches {n_attn} = 6 x "
        f"{calls}; eval wall {summary['timings']['wall_s']:.2f} s")

    log(f"phase 11b (TED): a TED-layout cache LMDB (6-tuples with vec_seq) "
        f"of {TED_WINDOWS} windows at TED's shapes -> convert_data cache")
    rng = np.random.RandomState(12)
    ted = []
    for i in range(TED_WINDOWS):
        ted.append([
            [[f"t{j}", 0.4 * j, 0.4 * j + 0.3] for j in range(2 + i % 4)],
            rng.randn(34, 10, 3).astype(np.float32),
            rng.randn(34, 9, 3).astype(np.float32),
            rng.randn(36267).astype(np.float32),
            (20 * rng.rand(128, 70) - 60).astype(np.float16),
            {"vid": f"ted{i // 10}", "start_frame_no": 34 * (i % 10),
             "end_frame_no": 34 * (i % 10) + 34,
             "start_time": 1.36 * (i % 10),
             "end_time": 1.36 * (i % 10) + 1.36}])
    ted_lmdb = write_lmdb(work / "ted_lmdb", {
        f"{i:010d}".encode(): arrow014.serialize(v)
        for i, v in enumerate(ted)})
    ted_desc, _ = lmdb_line(ted_lmdb)
    log(f"  TED cache LMDB: {ted_desc}")
    n_ted, ted_s = convert("cache", ted_lmdb, work / "ted_conv",
                           "TED windows")
    got = GestureStore(work / "ted_conv")
    names = ("word_seq", "pose_seq", "vec_seq", "audio", "spectrogram",
             "aux_info")
    for i, v in enumerate(ted):
        rec = got[i]
        if list(rec) != ["word_seq", "pose_seq", "audio", "spectrogram",
                         "aux_info", "vec_seq"] or not all(
                same_values(rec[k], x) for k, x in zip(names, v)):
            raise SystemExit(f"11b (TED): window {i} differs from its "
                             "source")
    got.close()
    if n_ted != TED_WINDOWS:
        raise SystemExit(f"11b (TED): {n_ted} records")
    shutil.rmtree(ted_lmdb)
    shutil.rmtree(work / "ted_conv")
    log(f"  [{card}] {n_ted} TED windows, every field equal to its source")
    return {"lmdb_bytes": int(size), "serialize_s": ser_s,
            "lmdb_write_s": write_s, "convert_s": conv_s,
            "eval": {k: summary[k] for k in METRICS},
            "eval_max_rel": worst, "eval_wall_s": summary["timings"][
                "wall_s"], "attention_launches": n_attn,
            "ted_convert_s": ted_s}


def phase_migrate_extras(card, work: Path, counts):
    """11c: BeatAlignerV1 on the converted store (the card's onset
    frontend and the host's); convert_data wordvec on 9b's vocabulary ->
    set_pretrained_embedding in the flagship generator on the card."""
    store = GestureStore(work / "migrated" / "test_cache")
    idx = np.arange(len(store))
    audio = store.batch_field(idx, "audio")
    poses = store.batch_field(idx, "pose_seq")
    store.close()
    log(f"phase 11c: BeatAlignerV1 over the converted store's {len(idx)} "
        "windows, the onset frontend on the card and on the host")
    aligner = BeatAlignerV1()
    t0 = time.perf_counter()
    on_card = aligner.score_batch(audio, poses, device_frontend=True,
                                  device=DEVICE)
    card_s = time.perf_counter() - t0
    on_host = aligner.score_batch(audio, poses)
    host_s = time.perf_counter() - t0 - card_s
    diff = abs(on_card - on_host)
    log(f"  [{card}] BeatAlignerV1: card frontend {on_card:.6f} "
        f"({card_s:.2f} s), host frontend {on_host:.6f} ({host_s:.2f} s); "
        f"|difference| {diff:.3e} (limit {BEAT_FRONTEND_TOL})")
    if not np.isfinite(on_card) or diff > BEAT_FRONTEND_TOL:
        raise SystemExit("11c: the card's onset frontend disagrees with "
                         "the host's")

    log("phase 11c (wordvec): convert_data wordvec on 9b's vocab_all.pkl "
        "and a seeded 300-d .vec -> set_pretrained_embedding in the "
        "flagship generator on the card, a forward at batch "
        f"{BATCH}")
    vocab_path = work / "beat" / "vocab_all.pkl"
    vocab = Vocab.load(vocab_path)
    rng = np.random.RandomState(13)
    words = sorted(vocab.word2index) + [f"oov{k}" for k in range(20)]
    vec = work / "wordvec" / "vectors.vec"
    vec.parent.mkdir()
    vec.write_text(f"{len(words)} 300\n" + "".join(
        w + " " + " ".join(f"{x:.5f}" for x in rng.randn(300)) + "\n"
        for w in words))
    npy = work / "wordvec" / "word_vectors.npy"
    n_rows = convert_cli.main(convert_cli.build_parser().parse_args([
        "wordvec", "--vocab", str(vocab_path), "--vectors", str(vec),
        "--out", str(npy)]))
    weights = np.load(npy)
    gen = gen_mod.GestureTransformer(n_words=n_rows, fused_attention=True,
                                     device=DEVICE)
    gen_mod.set_pretrained_embedding(gen, weights)
    installed = gen.text_encoder.embedding.weight
    if not torch.equal(installed.cpu(), torch.from_numpy(weights)) or \
            installed.device.type != torch.device(DEVICE).type:
        raise SystemExit("11c: the embedding does not equal the .npy")
    g = torch.Generator(device=DEVICE).manual_seed(14)
    reset_counts()
    with torch.no_grad():
        out = gen(torch.randn(BATCH, 128, 124, generator=g, device=DEVICE),
                  torch.randint(0, n_rows, (BATCH, 60), generator=g,
                                device=DEVICE),
                  torch.randn(BATCH, 10, 282, generator=g, device=DEVICE))
        torch.cuda.synchronize()
    n_attn = FA.launches
    finite = all(bool(torch.isfinite(t).all()) for t in out)
    if not finite or tuple(out[0].shape) != (BATCH, 60, 282) or n_attn != 6:
        raise SystemExit(f"11c: forward finite {finite}, poses "
                         f"{tuple(out[0].shape)}, attention launches "
                         f"{n_attn}")
    counts["fused_attention"] += n_attn
    del gen, out
    torch.cuda.empty_cache()
    shutil.rmtree(work / "wordvec")
    log(f"  [{card}] ({n_rows}, 300) vectors installed on the card, equal "
        f"to the .npy; forward at batch {BATCH} finite, poses "
        f"{(BATCH, 60, 282)}; attention launches {n_attn}")
    return {"beat_v1": {"card": on_card, "host": on_host, "abs_diff": diff,
                        "card_s": card_s, "host_s": host_s},
            "wordvec_rows": n_rows}


def phase_migrate(card, work: Path, counts, store):
    t0 = time.perf_counter()
    out = {"clips": phase_migrate_clips(card, work, counts),
           "windows": phase_migrate_windows(card, work, counts,
                                            store["eval"]),
           "extras": phase_migrate_extras(card, work, counts)}
    out["wall_s"] = time.perf_counter() - t0
    log(f"  [{card}] phase 11 wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the model zoo
# ---------------------------------------------------------------------------

ZOO_VARIANTS = ("base", "spatial_memory", "padding_initial")
ZOO_STEP_VARIANTS = ("base", "padding_initial")
ZOO_B = 64
# 12c-12d, card against CPU in fp32 with TF32 off: every output within
# 1e-4 of its largest entry (cuDNN / cuBLAS against the CPU's convolutions
# and GEMMs sum in other orders; the GRUs' recurrences and seq2seq's
# 59-step decode feed those differences back); HandCVAE the same
ZOO_REL = 1e-4
# 12d, the evaluator's statistics card against CPU: a covariance's sqrtm
# over 512 latents of 32 or 128 dims that agree to ~1e-6
ZOO_EVAL_REL = 1e-3


def check_rel(name, got, ref, rel=ZOO_REL) -> float:
    """max |got - ref| / max |ref| <= rel, logged; the share."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    share = float((got - ref).abs().max() / ref.abs().max().clamp(
        min=1e-30))
    ok = share <= rel and got.shape == ref.shape
    log(f"  {name}: max_abs_err / max|ref| {share:.3e} (at most {rel}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: the card disagrees with the CPU")
    return share


def phase_zoo_serving(gen, card, counts, serving):
    """12a: each variant's serving forward at phase 4's width."""
    memory_ms = {r["precision"]: r["cvae_generator_ms"] for r in serving}
    waves, y, text, prior, noise = requests(gen, BATCH,
                                            torch.device(DEVICE))
    out = {}
    for variant in ZOO_VARIANTS:
        for precision in ("float32", "bfloat16"):
            server = GestureServer(fused_attention=True, precision=precision,
                                   device=DEVICE, seed=0, variant=variant)
            spec = server.spectrogram(waves)
            server.forward_spec(spec, y, text, prior, noise=noise)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            poses = server.forward_spec(spec, y, text, prior,
                                        noise=noise)[0]
            torch.cuda.synchronize()
            launches = (FA.launches, FM.launches, FS.launches)
            if launches != (6, 0, 0):
                raise SystemExit(f"{variant} {precision}: launches "
                                 f"(attention, mel, SE stage) {launches}, "
                                 "want (6, 0, 0)")
            counts["fused_attention"] += FA.launches
            if poses.shape != (BATCH, 60, 282) or \
                    not torch.isfinite(poses).all():
                raise SystemExit(f"{variant} {precision}: bad poses")
            ms = cuda_ms(lambda: server.forward_spec(spec, y, text, prior,
                                                     noise=noise), iters=3)
            set_fused_attention(server.gen, False)
            plain = server.forward_spec(spec, y, text, prior, noise=noise)[0]
            set_fused_attention(server.gen, True)
            err = check_close(f"{variant} {precision} poses fused vs plain "
                              "path", poses, plain, **POSE_TOL[precision])
            log(f"  [{card}] {variant} {precision}: {ms:.1f} ms per "
                f"CVAE+generator forward of {BATCH} (memory, phase 4: "
                f"{memory_ms[precision]:.1f} ms); attention launches 6")
            res = {"ms_per_forward": ms, "memory_ms": memory_ms[precision],
                   "attention_launches": 6, "pose_err": err}
            if precision == "float32":
                cpu = GestureServer(fused_attention=True, device="cpu",
                                    seed=1, variant=variant)
                cpu.gen.load_state_dict({k: v.cpu() for k, v in
                                         server.gen.state_dict().items()})
                cpu.vae.load_state_dict({k: v.cpu() for k, v in
                                         server.vae.state_dict().items()})
                small = [t[:2] for t in (spec, y, text, prior, noise)]
                on_card = server.forward_spec(*small[:4],
                                              noise=small[4])[0]
                on_cpu = cpu.forward_spec(*[t.cpu() for t in small[:4]],
                                          noise=small[4].cpu())[0]
                res["card_vs_cpu"] = check_close(
                    f"{variant} 2 rows, card vs CPU", on_card.cpu(), on_cpu,
                    rtol=2e-3, atol=5e-4)
            out[f"{variant}_{precision}"] = res
            del server
    return out


def phase_zoo_train(card, work: Path):
    """12b: the GAN trainer's main per --variant (--preset fast), and one
    fp32 d_first step of `base` and `padding_initial` card vs CPU."""
    out = {}
    for variant in ZOO_VARIANTS:
        gen, disc, summary = train_once(
            f"variant {variant}", ["--preset", "fast", "--variant", variant],
            work / f"gan_{variant}", 1, False)
        if (gen.step, disc.step) != (EPOCH_STEPS, EPOCH_STEPS) or \
                gen.module.variant != variant:
            raise SystemExit(f"train {variant}: steps {gen.step}, "
                             f"{disc.step}, variant {gen.module.variant}")
        del gen, disc
        shutil.rmtree(work / f"gan_{variant}")
        ms = float(np.mean(summary["step_ms"][1:]))
        log(f"  [{card}] train --variant {variant} --preset fast: {ms:.2f} "
            f"ms per step (CUDA events, steps 2-{EPOCH_STEPS}; all: "
            f"{', '.join(f'{t:.2f}' for t in summary['step_ms'])}); losses "
            + ", ".join(f"{k} {v:.4f}" for k, v in
                        summary["metrics"].items())
            + "; no kernel launch")
        out[variant] = {"ms_per_step": ms, "step_ms": summary["step_ms"],
                        "losses": summary["metrics"]}
    batch = train_batch(STEP_B)
    for variant in ZOO_STEP_VARIANTS:
        card_step = one_step(DEVICE, batch, variant)
        cpu_step = one_step("cpu", batch, variant)
        worst, bad = step_errors(card_step, cpu_step)
        sp = [n for n, _ in card_step[1].module.named_buffers()
              if ".spatial_memory.bn" in n]
        log(f"  {variant} d_first step, d_model 128, card vs CPU "
            f"({len(sp)} SPMemoryV2 running statistics among the buffers): "
            "max_abs_err " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       worst.items())
            + f" ({'ok' if not bad else 'FAIL: ' + ', '.join(bad[:5])})")
        if bad:
            raise SystemExit(f"{variant} train step: the card disagrees "
                             "with the CPU")
        out[f"{variant}_card_vs_cpu"] = worst
    return out


def cvae_version_step(version, device, inputs):
    state = cvae_train.create_state(0, version=version, device=device)
    no_dropout(state.module)
    batch = {k: v.to(device) for k, v in inputs.items()}
    state, m = cvae_train.train_step(state, batch["features"],
                                     batch["eid_label"], 1,
                                     noise=batch["noise"])
    return state, {k: float(v) for k, v in m.items()}


def phase_zoo_cvae(card, work: Path):
    """12c: --cvae_version 1 and 2 on phase 6's fp32 generator, 2 epochs
    then --resume to step 12; one step of each card vs CPU; HandCVAE."""
    out = {}
    gan_dir = work / "gan_fp32"
    g = torch.Generator().manual_seed(12)
    inputs = {"features": torch.randn(AUX_STEP_B, 60, 512, generator=g),
              "eid_label": torch.nn.functional.one_hot(
                  torch.arange(AUX_STEP_B) % 8, 8).float(),
              "noise": torch.randn(AUX_STEP_B, 32, generator=g)}
    for version in (1, 2):
        extra = ["--generator_checkpoint", str(gan_dir), "--cvae_version",
                 str(version)]
        save = f"aux_cvae_v{version}"
        state, first = aux_once("cvae", work, 2, False, extra, save)
        if state.step != 2 * EPOCH_STEPS:
            raise SystemExit(f"cvae v{version}: step {state.step}")
        state, resumed = aux_once("cvae", work, 1, True, extra, save)
        if state.step != 3 * EPOCH_STEPS or \
                type(state.module).__name__ != f"EmotionCVAEv{version}":
            raise SystemExit(f"cvae v{version}: step {state.step} after "
                             f"--resume, {type(state.module).__name__}")
        del state
        res = trainer_numbers(first["step_ms"], TRAIN_BATCH,
                              max(first["peak_bytes"],
                                  resumed["peak_bytes"]), first["wall_s"])
        res["metrics"] = resumed["metrics"]
        log_trainer(card, f"cvae v{version}", res,
                    "; steps 8 -> 12; last metrics " + ", ".join(
                        f"{k} {v:.5f}" for k, v in res["metrics"].items()))
        (s0, m0), (s1, m1) = (cvae_version_step(version, d, inputs)
                              for d in ("cpu", DEVICE))
        worst, bad = state_errors({"": (s1, s0)}, m1, m0, 2e-4)
        log(f"  cvae v{version} step, card vs CPU: max_abs_err " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items())
            + f" ({'ok' if not bad else 'FAIL: ' + ', '.join(bad[:5])})")
        if bad:
            raise SystemExit(f"cvae v{version} step: the card disagrees "
                             "with the CPU")
        res["card_vs_cpu"] = worst
        out[f"v{version}"] = res
    torch.manual_seed(12)
    hand = cvae_models.HandCVAE(device=DEVICE)
    hand_cpu = cvae_models.HandCVAE(device="cpu")
    hand_cpu.load_state_dict({k: v.cpu() for k, v in
                              hand.state_dict().items()})
    x, y, z = (torch.randn(ZOO_B, *s, generator=g) for s in
               ((90,), (90,), (32,)))
    with torch.no_grad():
        got = hand(x.to(DEVICE), y.to(DEVICE), noise=z.to(DEVICE))[0]
        want = hand_cpu(x, y, noise=z)[0]
        out["hand"] = check_rel("HandCVAE forward", got, want)
        check_rel("HandCVAE sample", hand.sample(y.to(DEVICE),
                                                 noise=z.to(DEVICE)),
                  hand_cpu.sample(y, noise=z))
    return out


def zoo_nets(g):
    """12d's nets at the JAX constructors' default widths and their batch-64
    inputs: name -> (build(device), inputs, output to compare)."""
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    words = lambda *s: torch.randint(1, 64, s, generator=g)  # noqa: E731
    B = ZOO_B
    return {
        "seq2seq": (lambda d: bl.Seq2SeqNet(n_words=64, device=d),
                    (words(B, 34), torch.full((B,), 34), r(B, 60, 282))),
        "s2g_generator": (lambda d: bl.S2GGenerator(device=d),
                          (r(B, 128, 70), r(B, 4, 282))),
        "s2g_discriminator": (lambda d: bl.S2GDiscriminator(device=d),
                              (r(B, 34, 282),)),
        "trimodal_generator": (lambda d: bl.PoseGenerator(n_words=64,
                                                          device=d),
                               (r(B, 60, 283), words(B, 60),
                                0.1 * r(B, 64000))),
        "trimodal_discriminator": (lambda d: bl.TrimodalDiscriminator(
            device=d), (r(B, 60, 282),)),
        "conv_discriminator": (lambda d: bl.ConvDiscriminator(device=d),
                               (r(B, 60, 282),)),
        "hierarchy_wav_encoder": (lambda d: bl.HierarchicalWavEncoder(
            n_speakers=8, device=d), (r(B, 128, 124),
                                      torch.arange(B) % 8)),
        "hierarchy_generator": (lambda d: bl.HierarchicalPoseGenerator(
            n_words=64, device=d), (r(B, 60, 283), words(B, 60),
                                    r(B, 60, 32))),
        "hierarchy_discriminator": (lambda d: bl.HierarchicalDiscriminator(
            device=d), (r(B, 60, 282),)),
        "hierarchy_conv_discriminator": (
            lambda d: bl.HierarchicalConvDiscriminator(device=d),
            (r(B, 60, 282),)),
        "embedding_net": (lambda d: bl.EmbeddingNet(64, 27, 34, device=d),
                          (None, None, r(B, 4, 27), r(B, 34, 27))),
        "motion_ae": (lambda d: bl.MotionAE(device=d), (r(B, 34, 126),)),
        "legacy_linear": (lambda d: legacy.linear(512, 256).to(d),
                          (r(B, 512),)),
        "legacy_conv2d": (lambda d: legacy.conv2d(32, 64).to(d),
                          (r(B, 32, 32, 32),)),
        "legacy_conv_transpose2d": (
            lambda d: legacy.conv_transpose2d(64, 32).to(d),
            (r(B, 64, 16, 16),)),
        "legacy_nn_conv2d": (lambda d: legacy.nn_conv2d(32, 32).to(d),
                             (r(B, 32, 16, 16),)),
        "legacy_residual_block": (lambda d: legacy.ResidualBlock(16).to(d),
                                  (r(B, 16, 8, 8, 8),)),
    }


def flat_outputs(out):
    if out is None or isinstance(out, int):
        return []
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in flat_outputs(o)]
    return [out]


def phase_zoo_baselines(card):
    """12d: each baseline, discriminator and legacy factory card vs CPU at
    batch 64; the evaluator's statistics card vs CPU."""
    g = torch.Generator().manual_seed(12)
    out = {}
    reset_counts()
    for i, (name, (build, inputs)) in enumerate(zoo_nets(g).items()):
        torch.manual_seed(100 + i)
        net = build(DEVICE).eval()
        cpu = build("cpu").eval()
        cpu.load_state_dict({k: v.cpu() for k, v in
                             net.state_dict().items()})
        on_card = [None if t is None else t.to(DEVICE) for t in inputs]
        with torch.no_grad():
            got = flat_outputs(net(*on_card))
            want = flat_outputs(cpu(*inputs))
            ms = cuda_ms(lambda: net(*on_card), iters=3)
        share = max(check_rel(f"{name} output {j}", a, b)
                    for j, (a, b) in enumerate(zip(got, want)))
        if len(got) != len(want) or not got:
            raise SystemExit(f"{name}: outputs {len(got)} vs {len(want)}")
        log(f"  [{card}] {name}: {ms:.2f} ms per forward of {ZOO_B}")
        out[name] = {"ms_per_forward": ms, "card_vs_cpu": share}
        del net, cpu
    assert_no_launches("the baselines")
    for pose_dim in (27, 126):
        evs = {}
        for dev in (DEVICE, "cpu"):
            evs[dev] = zoo_eval.EmbeddingSpaceEvaluator(
                pose_dim, seed=5, device=dev,
                state_dict=None if dev == DEVICE else
                {k: v.cpu() for k, v in evs[DEVICE].net.state_dict().items()})
        r = np.random.RandomState(pose_dim)
        t0 = time.perf_counter()
        for _ in range(8):
            real = r.randn(ZOO_B, 34, pose_dim).astype(np.float32)
            fake = (0.7 * r.randn(ZOO_B, 34, pose_dim) + 0.3).astype(
                np.float32)
            for ev in evs.values():
                ev.push_samples(fake, real)
        wall = time.perf_counter() - t0
        (fd1, fdist1), (fd0, fdist0) = (evs[DEVICE].get_scores(),
                                        evs["cpu"].get_scores())
        div1, div0 = (evs[DEVICE].get_diversity_scores(),
                      evs["cpu"].get_diversity_scores())
        shares = [abs(a - b) / abs(b) for a, b in ((fd1, fd0),
                                                   (fdist1, fdist0),
                                                   (div1, div0))]
        ok = max(shares) <= ZOO_EVAL_REL and np.isfinite([fd1, fdist1,
                                                          div1]).all()
        log(f"  evaluator pose_dim {pose_dim}, 8 x {ZOO_B} windows: frechet "
            f"{fd1:.6f} (CPU {fd0:.6f}), feature distance {fdist1:.6f} "
            f"(CPU {fdist0:.6f}), diversity {div1:.6f} (CPU {div0:.6f}); "
            f"largest relative difference {max(shares):.3e} (at most "
            f"{ZOO_EVAL_REL}) {'ok' if ok else 'FAIL'}; both pushes "
            f"{wall:.2f} s")
        if not ok:
            raise SystemExit(f"evaluator {pose_dim}: the card disagrees "
                             "with the CPU")
        out[f"evaluator_{pose_dim}"] = {"frechet": fd1, "feat_dist": fdist1,
                                        "diversity": div1,
                                        "rel": max(shares)}
    return out


def phase_zoo(card, work: Path, gen, counts, serving):
    """Phase 12, in the work directory of phases 6-11 (12c reads phase 6's
    fp32 generator)."""
    t0 = time.perf_counter()
    parts = (
        ("serving", "12a: the generator variants' serving forward, batch "
         f"{BATCH}, fp32 and bf16, fused attention",
         lambda: phase_zoo_serving(gen, card, counts, serving)),
        ("train", f"12b: the GAN trainer per --variant (--preset fast, "
         f"--synthetic {TRAIN_SAMPLES}, batch {TRAIN_BATCH}, one epoch), "
         "then one d_first step of base and padding_initial card vs CPU",
         lambda: phase_zoo_train(card, work)),
        ("cvae", "12c: train_auxiliary --cvae_version 1 and 2 on phase 6's "
         "generator, card vs CPU steps, HandCVAE",
         lambda: phase_zoo_cvae(card, work)),
        ("baselines", "12d: the baselines, discriminators and legacy "
         f"factories at their default widths, batch {ZOO_B}, card vs CPU; "
         "the evaluator", lambda: phase_zoo_baselines(card)))
    out, walls = {}, {}
    for name, title, run in parts:
        log(f"phase {title}")
        t = time.perf_counter()
        out[name] = run()
        walls[name] = time.perf_counter() - t
    out["wall_s"] = time.perf_counter() - t0
    out["walls_s"] = walls
    log(f"  [{card}] phase 12 wall {out['wall_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# phase 13: the JAX package's orbax checkpoints on the card, the checkpoint
# converter, the 3x3 conv as GEMMs, the demo's --render
# ---------------------------------------------------------------------------

ORBAX_STEP = 40  # the step of 13a's TrainState trees
ORBAX_JAX = REPO / "tests" / "fixtures" / "orbax_jax"
# 13b: the port's outputs on the committed checkpoints against JAX's, of
# each output's largest entry: the parity default that
# tests/test_torch_port_orbax.py holds them to on the CPU
JAX_FIXTURE_TOL = dict(rtol=2e-4, atol=2e-5)
CONV_SHAPE = (128, 32, 31, 128, 128)  # B, H, W, C, K: stage 3 of the encoder
# 13d, against F.conv2d: fp32 (TF32 off) as tests/test_conv_gemm.py; bf16
# operands, both sides summing exact products in fp32 and rounding once to
# bf16: a bf16 ulp of the largest output (~16) is 0.0625
CONV_TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
            "bfloat16": dict(rtol=1e-2, atol=0.125)}
CONVERT_SAMPLES = 2 * TRAIN_BATCH  # 13c: 2 steps per epoch


def fixture_writer():
    """tests/fixtures/make_orbax_fixture.py (numpy only; shares no code with
    the port's reader): write_orbax and jax_state_tree."""
    sys.path.insert(0, str(REPO / "tests" / "fixtures"))
    try:
        import make_orbax_fixture
    finally:
        sys.path.pop(0)
    return make_orbax_fixture


class ZstdMeter:
    """Bytes decoded and seconds spent in the zstd decoder meanwhile."""

    def __enter__(self):
        self.bytes, self.seconds = 0, 0.0
        self._real = zstd_mod.decompress_into

        def timed(data, out):
            t = time.perf_counter()
            n = self._real(data, out)
            self.seconds += time.perf_counter() - t
            self.bytes += n
            return n

        zstd_mod.decompress_into = timed
        return self

    def __exit__(self, *exc):
        zstd_mod.decompress_into = self._real
        return False

    @property
    def mb_per_s(self) -> float:
        return self.bytes / max(self.seconds, 1e-9) / 1e6


def tree_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def generator_table_of(gen):
    """The port's weight table of `gen` (the TCN blocks with a downsample
    read off the module, where the JAX variables would tell)."""
    blocks = {f"block{i}": ({"downsample": {}} if blk.downsample is not None
                            else {})
              for i, blk in enumerate(gen.text_encoder.tcn.network)}
    return weights.generator_table(
        {"params": {"text_encoder": {"tcn": blocks}}},
        n_layers=len(gen.encoder.layer_stack), tcn_layers=len(blocks))


def write_jax_state(module, table, path: Path, seed: int):
    """`module`'s weights as a JAX TrainState tree at ORBAX_STEP with
    seeded Adam moments, written by the fixture writer. Returns the tree."""
    fx = fixture_writer()
    r = np.random.default_rng(seed)

    def moments(path, shape):
        mu = (1e-3 * r.standard_normal(shape, np.float32))
        return mu, np.abs(mu) * 1e-2

    state = {k: v.detach().cpu().numpy()
             for k, v in module.state_dict().items()}
    tree = fx.jax_state_tree(state, table, ORBAX_STEP, moments)
    fx.write_orbax(path, tree)
    return tree


def phase_orbax_full(card, work: Path, counts, serving):
    """13a: phase 4's serving weights (the flagship generator, CVAE v3)
    written as the JAX package's TrainState checkpoints, read back through
    the eval CLI, the demo and the serving modules."""
    root = work / "orbax13"
    src = GestureServer(fused_attention=True, precision="float32",
                        device=DEVICE, seed=0)
    tables = {"generator": generator_table_of(src.gen),
              "cvae": weights.cvae_v3_table()}
    t0 = time.perf_counter()
    trees = {name: write_jax_state(
        getattr(src, "gen" if name == "generator" else "vae"), tables[name],
        root / name / f"checkpoint_iteration{ORBAX_STEP}", i)
        for i, name in enumerate(("generator", "cvae"))}
    write_s = time.perf_counter() - t0
    mb = tree_bytes(root) / 1e6
    log(f"  wrote the generator and CVAE as JAX TrainStates (step "
        f"{ORBAX_STEP}, Adam moments): {mb:.1f} MB on disk in "
        f"{write_s:.2f} s")

    # the serving modules, loaded and timed per precision beside phase 4
    memory_ms = {r["precision"]: r["cvae_generator_ms"] for r in serving}
    waves, y, text, prior, noise = requests(
        torch.Generator(device=DEVICE).manual_seed(13), BATCH,
        torch.device(DEVICE))
    spec = src.spectrogram(waves)
    want = src.forward_spec(spec, y, text, prior, noise=noise)[0]
    out = {"write_s": write_s, "mb": mb}
    for precision in ("float32", "bfloat16"):
        server = GestureServer(fused_attention=True, precision=precision,
                               device=DEVICE, seed=7)
        torch.cuda.synchronize()
        with ZstdMeter() as meter:
            t0 = time.perf_counter()
            weights.load_reference_checkpoint(
                server.gen, root, subdir="generator",
                table=weights.jax_table("generator"))
            weights.load_reference_checkpoint(
                server.vae, root / "cvae", table=weights.jax_table("cvae"))
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
        read_mb = meter.bytes / 1e6  # params and batch_stats: no moments
        ms = cuda_ms(lambda: server.forward_spec(spec, y, text, prior,
                                                 noise=noise), iters=3)
        reset_counts()
        poses = server.forward_spec(spec, y, text, prior, noise=noise)[0]
        torch.cuda.synchronize()
        if FA.launches != 6 or not torch.isfinite(poses).all():
            raise SystemExit(f"13a {precision}: {FA.launches} attention "
                             "launches (want 6) or non-finite poses")
        counts["fused_attention"] += FA.launches
        if precision == "float32" and not torch.equal(poses, want):
            raise SystemExit("13a: poses from the orbax weights differ from "
                             "the source modules' in fp32")
        log(f"  [{card}] {precision}: params and batch_stats, {read_mb:.1f} "
            f"MB, read and loaded in {read_s:.2f} s ({read_mb / read_s:.0f} "
            f"MB/s; zstd at {meter.mb_per_s:.0f} MB/s, raw blocks); "
            f"CVAE+generator {ms:.1f} ms per forward of {BATCH} (phase 4: "
            f"{memory_ms[precision]:.1f} ms); attention launches 6"
            + ("; poses equal to the source modules' bit for bit"
               if precision == "float32" else ""))
        out[precision] = {"read_s": read_s, "read_mb": read_mb,
                          "read_mb_per_s": read_mb / read_s,
                          "zstd_mb_per_s": meter.mb_per_s,
                          "ms_per_forward": ms,
                          "memory_ms": memory_ms[precision]}
        del server

    # the eval CLI: its nets built from the orbax directories (the GAN
    # --model_save_path layout for the generator), one eval_batch of 1024
    args = eval_cli.build_parser().parse_args([
        "--synthetic", str(BATCH), "--test_batch_size", str(BATCH),
        "--device", DEVICE, "--fused_attention", "--checkpoints_folder_path",
        str(root), "--cvae_checkpoint", str(root / "cvae")])
    nets = eval_cli.build_models(args, eval_cli.N_WORDS_SYNTHETIC, DEVICE)
    if not str(nets.loaded["generator"]).endswith(
            f"generator/checkpoint_iteration{ORBAX_STEP}"):
        raise SystemExit(f"13a: eval CLI loaded {nets.loaded}")
    ref = eval_cli.build_models(eval_cli.build_parser().parse_args([
        "--synthetic", str(BATCH), "--device", DEVICE, "--fused_attention"]),
        eval_cli.N_WORDS_SYNTHETIC, DEVICE)
    ref.gen.load_state_dict(src.gen.state_dict())
    ref.vae.load_state_dict(src.vae.state_dict())
    for name in ("fgd", "skeleton"):
        getattr(ref, name).load_state_dict(getattr(nets, name).state_dict())
    batch = next(SyntheticGestureDataset(n_samples=BATCH, seed=13).batches(
        BATCH, shuffle=False, fields=("spectrogram", "text", "pose_seq",
                                      "eid_label")))
    inputs = [torch.from_numpy(batch[k]).to(DEVICE) for k in (
        "spectrogram", "text", "pose_seq", "eid_label")]
    z = noise[:BATCH]
    reset_counts()
    got = eval_cli.eval_batch(nets, *inputs, noise=z)
    torch.cuda.synchronize()
    n_attn = FA.launches
    expect = eval_cli.eval_batch(ref, *inputs, noise=z)
    if n_attn != 6 or not all(torch.equal(a, b) for a, b in
                              zip(got, expect)):
        raise SystemExit(f"13a: the eval CLI on the orbax weights: {n_attn} "
                         "attention launches (want 6) or outputs that "
                         "differ from the source modules'")
    counts["fused_attention"] += n_attn
    log(f"  eval CLI build_models on the orbax directories, eval_batch of "
        f"{BATCH}: poses, logits, FGD features and rotation error equal to "
        "the source modules' bit for bit; attention launches 6")

    # the demo on the orbax directories against the demo on .pth files of
    # the same modules
    torch.save(src.gen.state_dict(), root / "generator.pth")
    torch.save(src.vae.state_dict(), root / "cvae.pth")
    z = np.random.default_rng(13).standard_normal((2, 32)).astype(
        np.float32)
    poses = {}
    for name, (g, v) in {"orbax": (root / "generator", root / "cvae"),
                         "pth": (root / "generator.pth",
                                 root / "cvae.pth")}.items():
        dargs = demo.build_parser().parse_args([
            "--frontend", "pallas", "--num_samples", "2", "--device",
            DEVICE, "--out", str(root / f"demo_{name}"),
            "--checkpoints_folder_path", str(g), "--cvae_checkpoint",
            str(v)])
        reset_counts()
        summary = demo.main(dargs, noise=z)
        if FM.launches != 1:
            raise SystemExit(f"13a demo ({name}): {FM.launches} mel "
                             "launches (want 1)")
        counts["mel"] += FM.launches
        poses[name] = np.load(summary["out"])["poses"]
    if not np.array_equal(poses["orbax"], poses["pth"]):
        raise SystemExit("13a: the demo's poses from the orbax weights "
                         "differ from those from the .pth files")
    log("  demo --frontend pallas on the orbax directories: poses equal to "
        "the demo's on .pth files of the same modules; mel launches 1")
    return out, trees["generator"]["opt_state"][1]


def phase_orbax_jax(card):
    """13b: the committed checkpoints the JAX package's save_checkpoint
    wrote (zstd's compressed blocks, orbax's merged OCDBT tree), on the
    card, against JAX's outputs."""
    ref = np.load(ORBAX_JAX / "outputs.npz")
    dev = torch.device(DEVICE)
    vae = cvae_models.EmotionCVAEv3(feat_dim=32, device=DEVICE)
    fgd_net = FGDAutoEncoder(pose_dim=27, latent_dim=32, device=DEVICE)
    with ZstdMeter() as meter:
        for net, name in ((vae, "cvae"), (fgd_net, "fgd")):
            weights.load_reference_checkpoint(
                net, ORBAX_JAX / name, table=weights.jax_table(name))
    t = lambda k: torch.from_numpy(ref[k]).to(dev)  # noqa: E731
    with torch.no_grad():
        prior = vae.sample(t("cvae_y"), noise=t("cvae_z"))
        _, mu, logvar = vae(t("cvae_x"), t("cvae_y"), noise=t("cvae_z"))
        recon, feat = fgd_net(t("fgd_x"))
    errs = {}
    for name, got in (("cvae_prior", prior), ("cvae_mu", mu),
                      ("cvae_logvar", logvar), ("fgd_recon", recon),
                      ("fgd_feat", feat)):
        want = torch.from_numpy(ref[name])
        scale = want.abs().max().clamp_min(1e-12)
        errs[name] = check_close(f"13b {name} against JAX (of its largest "
                                 "entry)", got.cpu() / scale, want / scale,
                                 **JAX_FIXTURE_TOL)
    # the decoder on the fixture's compressed chunks, timed over repeats
    store = ocdbt.OcdbtStore(ORBAX_JAX / "cvae" / "checkpoint_iteration2")
    chunks = [store.read(k) for k in store.keys()
              if not k.endswith(b".zarray")]
    store.close()
    total, t0 = 0, time.perf_counter()
    for _ in range(20):
        for c in chunks:
            total += len(zstd_mod.decompress(c))
    mbs = total / (time.perf_counter() - t0) / 1e6
    log(f"  [{card}] zstd on the JAX-written chunks (Huffman literals, FSE "
        f"sequences): {total / 20 / 1e6:.2f} MB x 20 at {mbs:.0f} MB/s; "
        f"the loads decoded {meter.bytes / 1e6:.2f} MB")
    return {"errors": errs, "zstd_mb_per_s": mbs}


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def phase_convert(card, work: Path, orbax_root: Path, adam):
    """13c: a reference .pth of the flagship generator through
    convert_checkpoint, then the GAN trainer resumed from it for 2 steps;
    and resumed from 13a's orbax generator: the step and Adam's moments
    carried."""
    root = work / "convert13"
    root.mkdir(parents=True, exist_ok=True)
    torch.manual_seed(21)
    gen = gen_mod.GestureTransformer(n_words=64, device=DEVICE)
    torch.save({f"module.{k}": v for k, v in gen.state_dict().items()},
               root / "gen.pth")
    written = convert_ckpt_cli.main(convert_ckpt_cli.build_parser()
                                    .parse_args([
                                        "--kind", "generator", "--input",
                                        str(root / "gen.pth"), "--output",
                                        str(root / "gan" / "generator"),
                                        "--n_words", "64", "--device",
                                        DEVICE]))
    got = torch.load(written, weights_only=True)
    if got["step"] != 0 or any(not torch.equal(got["model"][k], v.cpu())
                               for k, v in gen.state_dict().items()):
        raise SystemExit("13c: the converted checkpoint differs from the "
                         ".pth")
    out = {}
    for name, model_dir, start in (("converted", root / "gan", 0),
                                   ("orbax", orbax_root, ORBAX_STEP)):
        if name == "orbax":
            state, _ = gan.create_states(gan.GANConfig(n_words=64), 0,
                                         DEVICE)
            state, ok = load_checkpoint(
                state, orbax_root / "generator",
                table=weights.jax_table("generator"))
            entries = {k: (path, kind) for k, path, kind in
                       generator_table_of(state.module)}
            bad = []
            for n, p in state.module.named_parameters():
                st = state.optimizer.state[p]
                path, kind = entries[n]
                for ours, theirs in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                    want = weights.TO_TORCH[kind](_at(adam[theirs], path[1:]))
                    if not np.array_equal(st[ours].cpu().numpy(), want):
                        bad.append(f"{n} {ours}")
                if int(st["step"]) != ORBAX_STEP:
                    bad.append(f"{n} step")
            if not ok or state.step != ORBAX_STEP or bad:
                raise SystemExit(f"13c: the orbax resume carried step "
                                 f"{state.step}, moments off in {bad[:3]}")
            del state
        args = train_cli.build_parser().parse_args([
            "--synthetic", str(CONVERT_SAMPLES), "--batch_size",
            str(TRAIN_BATCH), "--total_epoch", "1", "--device",
            DEVICE, "--save_every", "1000", "--model_save_path",
            str(model_dir), "--preset", "fast", "--resume"])
        reset_counts()
        t0 = time.perf_counter()
        g_state, _, summary = train_cli.main(args)
        wall = time.perf_counter() - t0
        if g_state.step != start + 2:
            raise SystemExit(f"13c ({name}): the trainer ended at step "
                             f"{g_state.step}, want {start + 2}")
        bad = [k for k, v in summary["metrics"].items()
               if not np.isfinite(v)]
        if bad or (FA.launches, FM.launches, FS.launches) != (0, 0, 0):
            raise SystemExit(f"13c ({name}): non-finite {bad} or kernel "
                             "launches in training")
        log(f"  [{card}] GAN trainer --resume from the {name} checkpoint "
            f"(step {start}): steps {start + 1}-{start + 2} in {wall:.1f} "
            "s, finite losses")
        out[name] = {"start": start, "end": g_state.step, "wall_s": wall}
        del g_state
    return out


def phase_conv_gemm(card):
    """13d: taps and im2col against F.conv2d (cuDNN) at the audio
    encoder's stage-3 shape, fp32 (TF32 off) and bf16."""
    B, H, W, C, K = CONV_SHAPE
    g = torch.Generator(device=DEVICE).manual_seed(4)
    x32 = torch.randn(B, H, W, C, generator=g, device=DEVICE)
    w32 = torch.randn(3, 3, C, K, generator=g, device=DEVICE) / 34
    F = torch.nn.functional
    out = {}
    for precision, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
        x, w = x32.to(dt), w32.to(dt)
        xc = x.permute(0, 3, 1, 2).contiguous()
        wc = w.permute(3, 2, 0, 1).contiguous()
        ref = F.conv2d(xc, wc, padding=1).permute(0, 2, 3, 1)
        res = {"conv2d_ms": cuda_ms(lambda: F.conv2d(xc, wc, padding=1),
                                    iters=5)}
        for name, fn in conv_gemm.CONV3X3_IMPLS.items():
            got = fn(x, w)
            res[f"{name}_err"] = check_close(
                f"13d {name} {precision} against F.conv2d", got, ref,
                **CONV_TOL[precision])
            res[f"{name}_ms"] = cuda_ms(lambda: fn(x, w), iters=5)
        log(f"  [{card}] {precision}: taps {res['taps_ms']:.3f} ms, im2col "
            f"{res['im2col_ms']:.3f} ms, F.conv2d {res['conv2d_ms']:.3f} ms "
            f"(NCHW, cuDNN); max |err| taps {res['taps_err']:.3e}, im2col "
            f"{res['im2col_err']:.3e}")
        out[precision] = res
    return out


def phase_render(card, work: Path):
    """13e: the demo's --render: with matplotlib, the first sample drawn;
    without it, the refusal before any model is built."""
    args = demo.build_parser().parse_args([
        "--render", "--num_samples", "1", "--device", DEVICE, "--out",
        str(work / "render13")])
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        built = []
        real = demo.GestureTransformer
        demo.GestureTransformer = lambda *a, **k: built.append(1)
        try:
            demo.main(args)
        except RuntimeError as exc:
            if "matplotlib" not in str(exc) or built:
                raise SystemExit(f"13e: the refusal is wrong: {exc}")
            log(f"  no matplotlib here: --render refused before any model "
                f"was built ({exc})")
            return {"matplotlib": False}
        finally:
            demo.GestureTransformer = real
        raise SystemExit("13e: --render ran without matplotlib")
    t0 = time.perf_counter()
    summary = demo.main(args)
    video = Path(summary["video"])
    if not video.exists() or video.stat().st_size == 0:
        raise SystemExit(f"13e: no video at {video}")
    log(f"  rendered the demo's first sample: {video.name}, "
        f"{video.stat().st_size} bytes, {time.perf_counter() - t0:.1f} s")
    return {"matplotlib": True, "video_bytes": video.stat().st_size}


def phase_orbax(card, work: Path, counts, serving):
    """Phase 13, in the work directory of phases 6-12."""
    t0 = time.perf_counter()
    out, walls, adam = {}, {}, {}

    def full():
        res, adam["generator"] = phase_orbax_full(card, work, counts,
                                                  serving)
        return res

    parts = (
        ("full", "13a: phase 4's weights as the JAX package's orbax "
         "checkpoints, read by the serving modules, the eval CLI and the "
         "demo", full),
        ("jax", "13b: the checkpoints the JAX package wrote "
         "(tests/fixtures/orbax_jax) against JAX's outputs",
         lambda: phase_orbax_jax(card)),
        ("convert", "13c: convert_checkpoint, then the GAN trainer "
         "--resume from it and from 13a's orbax generator",
         lambda: phase_convert(card, work, work / "orbax13",
                               adam.pop("generator"))),
        ("conv_gemm", "13d: the 3x3 conv as GEMMs at stage 3, B "
         f"{CONV_SHAPE[0]}", lambda: phase_conv_gemm(card)),
        ("render", "13e: the demo's --render", lambda: phase_render(
            card, work)))
    for name, title, run in parts:
        log(f"phase {title}")
        t = time.perf_counter()
        out[name] = run()
        walls[name] = time.perf_counter() - t
    out["wall_s"] = time.perf_counter() - t0
    out["walls_s"] = walls
    log(f"  [{card}] phase 13 wall {out['wall_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return out


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
    # g++ builds the zstd decoder while nvcc builds the kernels
    host_build = threading.Thread(target=zstd_mod.native)
    host_build.start()
    cuda_lib.build_all()
    host_build.join()
    zstd_mod.native()  # raises here if its build failed
    log(f"  nvcc, {len(cuda_lib.SOURCES)} sources in parallel, and g++ "
        f"for csrc/zstd.cpp: {time.perf_counter() - t0:.1f} s")
    for name, text in cuda_lib.build_logs.items():
        (args.out / f"nvcc_{name}.log").write_text(text)

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    attn_entry, attn_detail = phase_attention(gen)
    mel_entry = phase_mel(gen)
    # kernel 3 draws from its own generator, so the later phases see the
    # same inputs as before it was added
    se_gen = torch.Generator(device=DEVICE).manual_seed(3)
    se_entry, se_detail = phase_se_stage(se_gen)
    counts = {"fused_attention": 0, "mel": 0, "se_stage": 0}
    for precision in ("float32", "bfloat16"):
        phase_se_path(precision, se_gen, counts)
    phase_demo(args.out)
    serving = [phase_serving(p, gen, card, counts, args.profile)
               for p in ("float32", "bfloat16")]
    evals = phase_eval(card, counts, args.out)
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        train = phase_train(card, work, args.profile)
        aux = phase_aux(card, work)
        kfold = phase_kfold(card, work, args.profile)
        store = phase_store(card, work, counts, evals["fast"], train,
                            args.profile)
        dp = phase_dp(card, work, counts, evals)
        migrate = phase_migrate(card, work, counts, store)
        zoo = phase_zoo(card, work, gen, counts, serving)
        orbax_ckpt = phase_orbax(card, work, counts, serving)
    entries = (attn_entry, mel_entry, se_entry)
    for e in entries:
        e["launches"] = counts[e["name"]]
        if e["launches"] < 1:
            raise SystemExit(f"{e['name']}: not launched on the main path")

    detail = {"card": card, "serving": serving, "eval": evals,
              "train": train, "aux": aux, "classifier": kfold, "store": store,
              "data_parallel": dp, "migration": migrate, "zoo": zoo,
              "orbax": orbax_ckpt,
              "se_stage": se_detail, "attention": attn_detail}
    (args.out / "result.json").write_text(json.dumps(detail, indent=1))
    keys = ("ms_per_step", "samples_per_s", "peak_bytes", "wall_s")
    trainers = {f"gan_{k}": v for k, v in train.items() if k in TRAIN_RUNS}
    trainers.update({k: v for k, v in aux.items() if k in AUX_MODELS})
    trainers.update({f"classifier_{v['compute_dtype']}": v
                     for k, v in kfold.items() if k in KFOLD_PRESETS})
    log(json.dumps({"serving": serving, "trainers": {
        k: {m: v[m] for m in keys} for k, v in trainers.items()},
        "store": {"preprocess_wall_s": store["preprocess"]["wall_s"],
                  "eval_wall_s": store["eval"]["timings"]["wall_s"],
                  "eval_data_wait_s": store["eval"]["timings"]["data_wait_s"],
                  "gan_ms_per_step": store["train"]["ms_per_step"]},
        "migration": {"wall_s": migrate["wall_s"],
                      "clips_convert_s": migrate["clips"]["convert_s"],
                      "windows_convert_s": migrate["windows"]["convert_s"],
                      "eval_wall_s": migrate["windows"]["eval_wall_s"]},
        "zoo": {"wall_s": zoo["wall_s"], "serving_ms": {
            k: v["ms_per_forward"] for k, v in zoo["serving"].items()},
            "train_ms_per_step": {k: v["ms_per_step"] for k, v in
                                  zoo["train"].items()
                                  if k in ZOO_VARIANTS},
            "cvae_ms_per_step": {k: v["ms_per_step"] for k, v in
                                 zoo["cvae"].items() if k != "hand"},
            "baselines_ms": {k: v["ms_per_forward"] for k, v in
                             zoo["baselines"].items()
                             if "ms_per_forward" in v}},
        "orbax": {"wall_s": orbax_ckpt["wall_s"], **{
            p: {k: orbax_ckpt["full"][p][k] for k in (
                "read_s", "read_mb_per_s", "zstd_mb_per_s",
                "ms_per_forward")} for p in ("float32", "bfloat16")},
            "jax_written_zstd_mb_per_s": orbax_ckpt["jax"]["zstd_mb_per_s"],
            "conv_gemm": orbax_ckpt["conv_gemm"]}}))
    log(card)
    log(json.dumps({"kernels": list(entries)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
