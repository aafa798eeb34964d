#!/usr/bin/env python3
"""Where the attention kernel's time and error go: `csrc/attention.cu`
timed and checked with parts of it taken out or changed, on one NVIDIA card.

    python3 tools/attention_breakdown.py            # B=1024, 60 x 60, d 512
    python3 tools/attention_breakdown.py --out DIR  # where variants are built

Each variant is the kernel's source with edits made to its text: the
projections' small-term products dropped (one TF32 pass), every product of
the projections dropped (the GEMM loops keep their cp.async staging and
barriers, the epilogues stay), TF32 rounding by cvt.rna.tf32.f32 in place
of the integer ops (the same rounding), the Q/K/V GEMM in block tiles of
128 x 256 at one block per SM in place of 128 x 128 at two, and three ways
of summing the split products other than the kernel's (each 8-deep k-step
summed by the mma into a fresh accumulator, then added to the running sum
by fp32 adds): every mma summing into the running sum itself (the tensor
cores' own accumulation), in the GEMMs and the core or in the core alone,
and the GEMMs' large term alone so. Variants that drop products compute
wrong outputs on purpose; the others must agree with the plain version
within the tolerance of the TPU kernel's tests, and their largest error
against it is reported. Every
variant is built by `nvcc` with the port's flags (one process each, all at
once) and launched through the port's own wrapper `ops/fused_attention.py`
on inputs made as in phase 2a of chip_smoke.py: self-attention with fp32
activations and bf16 weights (bf16 serving), the first decoder layer's
cross-attention with a bf16 query, and self-attention in fp32 throughout.
Each launch is timed under torch.profiler, so the three kernels are timed
apart. The last line is one JSON object with the card and each variant's
ms per kernel and error. An edit that no longer finds its text in the
kernel fails the script.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from emotiongestures_torch.ops import cuda_lib  # noqa: E402
from emotiongestures_torch.ops import fused_attention as FA  # noqa: E402

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_pallas_attention.py
SMALL_TERMS = ("          if (kSplitA) mma_tf32(c, al[i], bh[0], bh[1]);\n"
               "          if (kSplitW) mma_tf32(c, ah[i], bl[0], bl[1]);\n")
LARGE_TERM = "          mma_tf32(c, ah[i], bh[0], bh[1]);\n"
INT_ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n"
CVT = ("  uint32_t r;\n"
       '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
       "  return r;\n")
WIDE_TILE = [  # the Q/K/V block tile 128 x 256, one block per SM
    ("kPBN = 128;", "kPBN = 256;"),
    ("kPBlocks = 2;", "kPBlocks = 1;"),
    ("  float acc[2][8][4];\n  gemm_tile<TA, TW, kPBM, kPBN, 2, 2, 8,",
     "  float acc[4][8][4];\n  gemm_tile<TA, TW, kPBM, kPBN, 4, 4, 8,"),
    ("wr = (warp / 2) * 32, wc = (warp % 2) * 64;",
     "wr = (warp / 4) * 64, wc = (warp % 4) * 64;"),
    ("  for (int i = 0; i < 2; ++i)\n#pragma unroll\n    for (int half",
     "  for (int i = 0; i < 4; ++i)\n#pragma unroll\n    for (int half"),
]
FRESH = "float c[4] = {0.f, 0.f, 0.f, 0.f};\n"


def running_sum(pad: str, first: str, acc: str):
    """Edits that make the mma sum into `acc` itself (the tensor cores'
    running sum) in place of a fresh `c` added to it by add4."""
    return [(f"{pad}{FRESH}{pad}{first}", f"{pad}float (&c)[4] = {acc};\n"
             f"{pad}{first}"), (f"{pad}add4({acc}, c);\n", "")]


RUNNING_GEMM = running_sum(" " * 10, "if (kSplitA)", "acc[i][j]")
RUNNING_CORE = (running_sum(" " * 8, "mma_tf32(c, al,", "s[j]")
                + running_sum(" " * 10, "mma_tf32(c, al,", "o[n]"))
LARGE_ON_RUNNING = [(LARGE_TERM + "          add4(acc[i][j], c);\n",
                     "          add4(acc[i][j], c);\n"
                     + LARGE_TERM.replace("(c,", "(acc[i][j],"))]
EDITS = {  # variant: ([(text, replacement)], checked against plain)
    "full": ([], True),
    "one TF32 pass in the projections": ([(SMALL_TERMS, "")], False),
    "no products in the projections": (
        [(SMALL_TERMS, ""), (LARGE_TERM, "")], False),
    "rounding by cvt.rna.tf32.f32": ([(INT_ROUND, CVT)], True),
    "Q/K/V in 128 x 256 tiles, one block per SM": (WIDE_TILE, True),
    "tensor cores' running sum, GEMMs and core": (
        RUNNING_GEMM + RUNNING_CORE, True),
    "tensor cores' running sum, core": (RUNNING_CORE, True),
    "large term on the tensor cores' running sum, GEMMs": (
        LARGE_ON_RUNNING, True),
}
KERNELS = ("mha_qkv", "mha_core", "mha_out_ln")


def kernel_ms(fn, iters: int) -> dict:
    """ms per call of each attention kernel, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((k for k in KERNELS if k in evt.key), None)
        if key is not None:
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
            out[key] = out.get(key, 0.0) + us / 1e3 / iters
    if sorted(out) != sorted(KERNELS):
        raise SystemExit(f"attention_breakdown: profiled {sorted(out)}")
    out["sum"] = sum(out[k] for k in KERNELS)
    return out


def inputs(gen, B, L, D, q_dtype, w_dtype, self_attn):
    q = torch.randn(B, L, D, generator=gen, device="cuda").to(q_dtype)
    kv = q if self_attn else torch.randn(B, L, D, generator=gen,
                                         device="cuda")
    ws = [(torch.randn(D, D, generator=gen, device="cuda") / D ** 0.5)
          .to(w_dtype) for _ in range(4)]
    s = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(w_dtype)
    b = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(w_dtype)
    return (q, kv, *ws, s, b)


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--out", type=Path,
                        default=REPO / ".runs" / "attention_breakdown")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_breakdown: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    libs = cuda_lib.build_variants(
        "attention", {name: cuda_lib.edited_source("attention", edits)
                      for name, (edits, _) in EDITS.items()}, args.out)
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    B = args.batch
    cases = {"self 60x60 act fp32, w bf16": inputs(gen, B, 60, 512, f32,
                                                   bf16, True),
             "cross 60x60 q bf16, kv fp32, w bf16": inputs(gen, B, 60, 512,
                                                           bf16, bf16, False),
             "self 60x60 fp32": inputs(gen, B, 60, 512, f32, f32, True)}
    refs = {case: FA.fused_attention_plain(*ops, n_head=8, d_k=64)
            for case, ops in cases.items()}
    results = {}
    for name, lib in libs.items():
        for case, ops in cases.items():
            with cuda_lib.using("attention", lib):
                got = FA.fused_attention(*ops)
                torch.cuda.synchronize()
                t = kernel_ms(lambda: FA.fused_attention(*ops), args.iters)
            if EDITS[name][1]:
                t["max_abs_err"] = (got - refs[case]).abs().max().item()
                if not torch.allclose(got, refs[case], **ATTN_TOL):
                    raise SystemExit(f"variant {name!r} disagrees with the "
                                     f"plain version in {case}")
            results[f"{name} | {case}"] = t
            print(f"{name} | {case}: " + ", ".join(
                f"{k} {v:.4f} ms" if k != "max_abs_err" else f"{k} {v:.3e}"
                for k, v in t.items()), flush=True)
    print(json.dumps({"card": card, "batch": B, "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
