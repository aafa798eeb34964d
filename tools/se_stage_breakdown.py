#!/usr/bin/env python3
"""Where the bf16 SE-stage kernel's time goes: `csrc/se_stage.cu`'s
cluster kernel timed and checked with parts of it taken out, on one NVIDIA
card.

    python3 tools/se_stage_breakdown.py            # B=1024, 32 x 31, 5 blocks
    python3 tools/se_stage_breakdown.py --out DIR  # where variants are built

Each variant is the kernel's source with edits made to its text: the
weight tiles loaded by each CTA for itself in place of multicast to the
cluster; a ring of 2 weight slots in place of 4; each k-tile's wgmma
waited for before the next k-tile's A fragments load (in place of one
k-tile in flight); the SE fcs skipped; every wgmma dropped (the ring, the
ldmatrix loads, the barriers, halo copies and epilogues stay); and every
wgmma and the whole weight ring dropped (no TMA load issued, waited for or
released). A last variant reads the SM's clock at each phase boundary of
every block (thread 0 of rank 0, in the clusters of samples 0 and B/2) and
reports each phase's cycles: the next block's set-up (cluster barrier
arrive, cp.async issue), conv1, epilogue 1, conv2, z and its column sums,
the pool's cluster barrier, the pool over DSMEM, the SE fcs and the output
epilogue. The kernel runs the whole stage in one launch, so there is no
variant with one launch per block. Variants that drop products compute
wrong outputs on purpose; the others must agree with the plain version
within the tolerance of chip_smoke.py's `se_tol` (8 bf16 steps of max
|ref|), and their largest error against it is reported. Every variant is
built by `nvcc` with the port's flags (one process each, all at once) and
launched through the port's own wrapper `ops/fused_se_stage.py` on the
operands of chip_smoke.py's phase 2c (five SEBasicBlocks, seed 0). Each
variant is timed with CUDA events over `--iters` calls after a warm-up, in
turns (the full kernel first and last). The last line is one JSON object
with the card, the cluster count the card holds, each variant's ms and
error, and the phase cycles. An edit that no longer finds its text in the
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

from emotiongestures_torch.nn.resnet_se import SEBasicBlock  # noqa: E402
from emotiongestures_torch.ops import cuda_lib  # noqa: E402
from emotiongestures_torch.ops import fused_se_stage as FS  # noqa: E402

WGMMA = ("          wgmma_m64n128k16(acc, a[h][kk], desc + 2 * kk, "
         "i + h + kk);\n")
SE_CALL = "    se_gate<__nv_bfloat16>("
NO_RING = [  # no weight tile issued, waited for or released
    ("      issue(blk, 0);\n", ""), ("      issue(blk, 1);\n", ""),
    ("        mbar_wait(full + 8 * stage, phase);\n", ""),
    ("  auto release = [&](int s) {\n",
     "  auto release = [&](int s) {\n    return;\n"),
]
# the phase clock: thread 0 of rank 0 in the clusters of samples 0 and
# B // 2 reads clock64 at each phase boundary into a device array (and the
# global timer at the ends, for the clock rate)
PHASES = ("set-up", "conv1 (+ x halo)", "epilogue 1", "conv2 (+ y halo)",
          "z and column sums", "cluster barrier 2", "pool over DSMEM",
          "SE fcs", "output epilogue")
_PROBE = ("if (threadIdx.x == 0 && blockIdx.x == 0 && (blockIdx.y == 0 || "
          "blockIdx.y == g_probe))")
_SLOT = "g_clock[(blockIdx.y ? 64 : 0) + (%s)]"


def _mark(idx: str) -> str:
    return "{ %s %s = clock64(); }\n" % (_PROBE, _SLOT % idx)


def _now(idx: str) -> str:
    return ("{ %s { long long t; asm volatile(\"mov.u64 %%0, %%%%globaltimer;"
            "\" : \"=l\"(t)); %s = t; } }\n" % (_PROBE, _SLOT % idx))


def _before(text: str, idx: str):
    """An edit that reads the clock for boundary `idx` just before `text`."""
    return (text, _mark(idx) + text)


_BLOCK_END = "    cluster_arrive();\n    consumer_sync();\n  }\n"
_POOL = "    cluster_sync();\n    // the sample's sum"
PHASE_CLOCK = [
    ("namespace {\n", "__device__ long long g_clock[128];\n"
     "__device__ int g_probe;\nnamespace {\n"),
    ("  cluster_sync();  // barriers initialised and tiles loaded in every "
     "CTA\n", _now("61") + _mark("0") + "  cluster_sync();\n" + _mark("1")),
    _before("    conv(xt, [&] {\n", "2 + 10 * blk"),
    _before("    cp_async_wait();\n", "3 + 10 * blk"),
    _before("    cluster_arrive();\n    consumer_sync();\n    conv(yt",
            "4 + 10 * blk"),
    _before("    // z = conv * s2 + t2, kept in acc;", "5 + 10 * blk"),
    (_POOL, _mark("6 + 10 * blk") + "    cluster_sync();\n"
     + _mark("7 + 10 * blk") + "    // the sample's sum"),
    _before(SE_CALL + "sum", "8 + 10 * blk"),
    _before("    // x = bf16(relu(z * gate + x)), over the input tile\n",
            "9 + 10 * blk"),
    _before(_BLOCK_END, "10 + 10 * blk"),
    ("  cluster_wait();  // no CTA exits",
     _mark("60") + _now("62") + "  cluster_wait();  // no CTA exits"),
]
CLOCK_ACCESS = """
extern "C" int eg_se_phase_clock(void* host, int probe) {
  if (host == nullptr)
    return (int)cudaMemcpyToSymbol(g_probe, &probe, sizeof(int));
  return (int)cudaMemcpyFromSymbol(host, g_clock, sizeof(g_clock));
}
"""
EDITS = {  # variant: ([(text, replacement)], checked against plain)
    "full": ([], True),
    "no multicast": ([("kMulticast = true;", "kMulticast = false;")], True),
    "one k-tile at a time": ([("wgmma_wait<1>();", "wgmma_wait<0>();")],
                             True),
    "ring of 2 slots": ([("kStages = 4;", "kStages = 2;")], True),
    "no SE gate": ([(SE_CALL, "    if (0) se_gate<__nv_bfloat16>(")], False),
    "no products": ([(WGMMA, "")], False),
    "no products, no weight ring": ([(WGMMA, ""), *NO_RING], False),
}


def operands(seed: int):
    """The stacked operands of five SEBasicBlock(128, 128) in eval mode,
    BatchNorm off its init (chip_smoke.py's se_blocks)."""
    torch.manual_seed(seed)
    g = torch.Generator().manual_seed(seed)
    blocks = [SEBasicBlock(128, 128) for _ in range(5)]
    with torch.no_grad():
        for blk in blocks:
            for m in blk.modules():
                if hasattr(m, "running_var"):
                    m.running_mean.normal_(0.0, 0.2, generator=g)
                    m.running_var.uniform_(0.5, 1.5, generator=g)
                    m.weight.normal_(1.0, 0.2, generator=g)
                    m.bias.normal_(0.0, 0.1, generator=g)
    return [t.cuda() for t in FS.stage_params_from_module(blocks)]


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_clock(lib, x, ops) -> dict:
    """Cycles of each phase of each block, on rank 0 of the clusters of
    samples 0 and B // 2, from the phase-clock variant."""
    import ctypes

    probe = x.shape[0] // 2
    if lib.eg_se_phase_clock(None, probe) != 0:
        raise SystemExit("phase clock: cudaMemcpyToSymbol failed")
    with cuda_lib.using("se_stage", lib):
        FS.fused_se_stage(x, *ops)
        torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 128)()
    if lib.eg_se_phase_clock(ctypes.byref(buf), 0) != 0:
        raise SystemExit("phase clock: cudaMemcpyFromSymbol failed")
    out = {}
    for base, sample in ((0, 0), (64, probe)):
        v = buf[base:base + 64]
        rows, prev = [], v[1]
        for blk in range(5):
            row = []
            for k in range(2, 11):
                row.append(v[k + 10 * blk] - prev)
                prev = v[k + 10 * blk]
            rows.append(dict(zip(PHASES, row)))
        total = v[60] - v[0]
        ghz = total / max(v[62] - v[61], 1)
        out[f"sample {sample}"] = {"blocks": rows, "total_cycles": total,
                                   "start_barrier": v[1] - v[0],
                                   "end": v[60] - prev, "clock_ghz": ghz}
        print(f"phase clock, sample {sample} (rank 0, {ghz:.3f} GHz): "
              f"{total} cycles")
        for k, name in enumerate(PHASES):
            print(f"  {name}: " + ", ".join(str(r[name]) for r in rows))
    return out


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--out", type=Path,
                        default=REPO / ".runs" / "se_stage_breakdown")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("se_stage_breakdown: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    sources = {name: cuda_lib.edited_source("se_stage", edits)
               for name, (edits, _) in EDITS.items()}
    sources["phase clock"] = (cuda_lib.edited_source("se_stage", PHASE_CLOCK)
                              + CLOCK_ACCESS)
    libs = cuda_lib.build_variants("se_stage", sources, args.out)
    ops = operands(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, W = args.batch, 32, 31
    x = torch.relu(torch.randn(B, H, W, 128, generator=gen,
                               device="cuda")).bfloat16()
    ref = FS.fused_se_stage_plain(x, *ops).float()
    limit = 8 * 2.0 ** -8 * ref.abs().max().item()
    with cuda_lib.using("se_stage", libs["full"]):
        clusters = FS.active_clusters(H, W)
    print(f"clusters of {FS.cluster_layout(H, W)[1]} CTAs the card holds "
          f"at once: {clusters}", flush=True)
    results = {}
    for name in list(EDITS) + ["full"]:  # the full kernel first and last
        with cuda_lib.using("se_stage", libs[name]):
            got = FS.fused_se_stage(x, *ops)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: FS.fused_se_stage(x, *ops), args.iters)
        entry = results.setdefault(name, {"ms": []})
        entry["ms"].append(ms)
        if EDITS[name][1]:
            err = (got.float() - ref).abs().max().item()
            entry["max_abs_err"] = err
            if err > limit:
                raise SystemExit(f"variant {name!r} disagrees with the plain "
                                 f"version: {err:.4f} > {limit:.4f}")
        err = (f", max_abs_err {entry['max_abs_err']:.4f} (limit {limit:.4f})"
               if EDITS[name][1] else "")
        print(f"{name}: {ms:.4f} ms{err}", flush=True)
    phases = phase_clock(libs["phase clock"], x, ops)
    print(json.dumps({"card": card, "batch": B, "shape": [H, W, 128, 5],
                      "active_clusters": clusters, "variants": results,
                      "phase_cycles": phases}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
