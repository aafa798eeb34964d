"""--preset fast|parity for the eval CLI and the GAN trainer (a copy of
emotiongestures_tpu/cli/presets.py's tables for those two).

`parity` (the default) keeps the reference-faithful fp32 configuration.
`fast` expands to --precision bfloat16 --fused_attention --device_beat in
the eval CLI, and to --compute_dtype bfloat16 --update_order g_first in the
trainer.
Expansion only touches flags the user left at their parser default, so an
explicit flag always wins over the preset (e.g. `--preset fast --precision
float32` keeps fp32).
"""
from __future__ import annotations

import argparse
import logging

EVAL_FAST = {
    "precision": "bfloat16",
    "fused_attention": True,
    "device_beat": True,
}

GAN_TRAIN_FAST = {
    "compute_dtype": "bfloat16",
    "update_order": "g_first",
}


def add_preset_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--preset", type=str, default="parity", choices=["parity", "fast"],
        help="parity (default): reference-faithful fp32 config. "
             "fast: eval, the bf16 generator and CVAE, the fused attention "
             "kernel and the beat frontend on the card; training, bf16 "
             "compute and update_order g_first. Explicit flags override it")


def _explicitly_set(name: str, args, parser, argv) -> bool:
    """Did the user set --name themselves? With the raw argv (command-line
    runs) this is exact; without it (main(args=...)), compare against the
    parser default."""
    if argv is not None:
        flag = f"--{name}"
        return any(a == flag or a.startswith(flag + "=") for a in argv)
    return getattr(args, name) != parser.get_default(name)


def apply_preset(args: argparse.Namespace,
                 parser: argparse.ArgumentParser,
                 table: dict, argv=None) -> argparse.Namespace:
    """Expand `--preset fast` into `table`'s flag values, skipping any flag
    the user set explicitly."""
    if getattr(args, "preset", "parity") != "fast":
        return args
    for name, value in table.items():
        if _explicitly_set(name, args, parser, argv):
            logging.info("--preset fast: keeping explicit --%s %r", name,
                         getattr(args, name))
        else:
            setattr(args, name, value)
            logging.info("--preset fast: %s = %r", name, value)
    return args
