#!/usr/bin/env python3
"""Where the mel kernel's time goes: `csrc/mel.cu` timed with parts of it
taken out, on one NVIDIA card.

    python3 tools/mel_breakdown.py            # serving batch, 1024 x 4 s
    python3 tools/mel_breakdown.py --out DIR  # where the variants are built

Each variant is the kernel's source with one edit made to its text: the
second and third radix-8 passes dropped, the band loop of the filterbank
run over no bins, or both. The variants compute wrong mels on purpose; only
the unedited kernel is checked, against its plain version. Every variant is
built by `nvcc` with the port's flags (one process each, all at once) and
launched through the port's own wrapper `ops/fused_mel.py::mel_power` on the
same padded waves, timed with CUDA events. The last line is one JSON object
with the card and each variant's ms. An edit that no longer finds its text
in the kernel fails the script.
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
from emotiongestures_torch.ops import fused_mel as FM  # noqa: E402
from emotiongestures_torch.ops import mel as M  # noqa: E402

PASSES = ("  pass_in_place<8, kPer>(buf, fr, j, ptw);\n"
          "  pass_in_place<64, kPer>(buf, fr, j, ptw);\n")
BAND_LOOP = "for (int q = 0; q < band.y; ++q) {"
EDITS = {  # variant: (text, replacement)
    "full": [],
    "without passes 2-3": [(PASSES, "")],
    "without the band loop": [(BAND_LOOP, "for (int q = 0; q < 0; ++q) {")],
    "without both": [(PASSES, ""),
                     (BAND_LOOP, "for (int q = 0; q < 0; ++q) {")],
}


def cuda_ms(fn, iters: int) -> float:
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


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--clips", type=int, default=1024)
    parser.add_argument("--samples", type=int, default=64000)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--out", type=Path,
                        default=REPO / ".runs" / "mel_breakdown")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("mel_breakdown: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    libs = cuda_lib.build_variants(
        "mel", {name: cuda_lib.edited_source("mel", edits)
                for name, edits in EDITS.items()}, args.out)
    gen = torch.Generator(device="cuda").manual_seed(0)
    waves = torch.randn(args.clips, args.samples, generator=gen,
                        device="cuda")
    padded = M.pad_center(waves)
    nf = M.n_frames_of(padded.shape[-1])
    ref = FM.mel_power_plain(padded, nf)
    times = {}
    for name, lib in libs.items():
        with cuda_lib.using("mel", lib):
            if name == "full":
                got = FM.mel_power(padded, nf)
                torch.cuda.synchronize()
                if not torch.allclose(got, ref, rtol=2e-3, atol=1e-3):
                    raise SystemExit("the unedited kernel disagrees with "
                                     "its plain version")
            times[name] = cuda_ms(lambda: FM.mel_power(padded, nf),
                                  args.iters)
        print(f"{name}: {times[name]:.4f} ms", flush=True)
    print(json.dumps({"card": card, "clips": args.clips,
                      "frames": args.clips * nf, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
