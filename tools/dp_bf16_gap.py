#!/usr/bin/env python3
"""Where the data-parallel eval's bf16 gap comes from, on one NVIDIA card.

    python3 tools/dp_bf16_gap.py

Two ranks are spawned on cuda:0 and joined over gloo, as in
`chip_smoke.py` phase 10b. For each preset (`fast`: bf16 generator and
CVAE; `parity`: fp32) rank 0 runs `eval_batch` at full width on the global
batch of 1024 twice as one process (run-to-run spread), then both ranks run
it on their 512 rows: once as the port does, and once with TMMemory's batch
coupling computed from the gathered rows in the inputs' own type, exactly
as one process computes it. If the second case reads like the first, the
gap to one process comes from the per-rank batch shape (the bf16
convolutions and products of 512 rows against 1024), not from the sum
all-reduce. The last line is one JSON object: per preset and case, the
largest absolute error of the poses and of the FGD features against the
first one-process run, with the card and its power limit.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as C  # noqa: E402
from emotiongestures_torch.models import generator as G  # noqa: E402
from emotiongestures_torch.parallel import distributed, mesh  # noqa: E402


def gathered_coupling(mem, pe):
    """mem^T @ pe over the gathered rows, in the inputs' type."""
    return mesh.all_gather(mem).T @ mesh.all_gather(pe)


def rank_errors():
    C.fp32_exact_on_cuda()
    raw = next(C.SyntheticGestureDataset(n_samples=C.BATCH, seed=4).batches(
        C.BATCH, shuffle=False, fields=C.DP_EVAL_FIELDS))
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    batch["noise"] = torch.randn(C.BATCH, 32,
                                 generator=torch.Generator().manual_seed(8))
    local = C.dp_local(batch)
    inputs = [local[k] for k in C.DP_EVAL_FIELDS]
    out = {}
    for preset in ("fast", "parity"):
        args = C.eval_cli.build_parser().parse_args(["--device", "cuda",
                                                     "--preset", preset])
        C.eval_cli.apply_preset(args, C.eval_cli.build_parser(),
                                C.eval_cli.EVAL_FAST)
        nets = C.eval_cli.build_models(args, C.eval_cli.N_WORDS_SYNTHETIC,
                                       torch.device("cuda"))
        refs = []
        if distributed.is_primary():
            with mesh.single_process():
                for _ in range(2):
                    refs.append(C.eval_cli.eval_batch(
                        nets, *[batch[k].cuda() for k in C.DP_EVAL_FIELDS],
                        noise=batch["noise"].cuda()))
        distributed.barrier()

        def two_ranks():
            o = C.eval_cli.eval_batch(nets, *inputs, noise=local["noise"])
            return [mesh.all_gather(t) for t in (o[0], o[2])]

        cases = {"two ranks": two_ranks()}
        honest = G.batch_coupling
        G.batch_coupling = gathered_coupling
        try:
            cases["two ranks, coupling from gathered rows"] = two_ranks()
        finally:
            G.batch_coupling = honest
        if distributed.is_primary():
            ref = refs[0]
            cases["one process again"] = [refs[1][0], refs[1][2]]
            out[preset] = {
                name: {"poses": float((got[0] - ref[0]).abs().max()),
                       "FGD features": float((got[1] - ref[2]).abs().max())}
                for name, got in cases.items()}
        del nets, refs
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("dp_bf16_gap: no CUDA device", file=sys.stderr)
        return 2
    C.cuda_lib.build_all()
    errors = mesh.launch(rank_errors, 2, device="cuda", backend="gloo",
                         timeout=600)[0]
    print(json.dumps({"card": C.card_line(), "max_abs_err": errors}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
