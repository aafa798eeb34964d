"""One-shot migration of reference PyTorch checkpoints into the port's
trainer checkpoints (port of emotiongestures_tpu/cli/convert_checkpoint.py,
with its flags and its seven kinds).

    python -m emotiongestures_torch.cli.convert_checkpoint --kind generator \
        --input gen.pth --output runs/gan/generator

The eval CLI and the demo read reference `.pth` files directly; this
converter is for the training side. It builds the model of `--kind` at the
flags' geometry, loads the `.pth` into it (a plain state_dict, a
DataParallel `module.` prefix, or the reference's rich dict whose
`gen_dict` holds it, utils/train_utils.py:168-213; tensors only unless
`--allow_pickle`), adds a fresh Adam from `core.schedules.adam(lr)` and
writes `<output>/checkpoint_iteration0.pt` at step 0, which the port's
trainers `--resume` from (the GAN trainer reads `<model_save_path>/
generator`, the auxiliary trainers `<model_save_path>/<model>`) and its
eval CLI's checkpoint flags read. Runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import logging

from ..core import schedules
from ..core.device import resolve_device
from ..models.cvae import EmotionCVAEv1, EmotionCVAEv2, EmotionCVAEv3
from ..models.emotion_net import EmotionNet
from ..models.fgd_ae import FGDAutoEncoder
from ..models.generator import GestureTransformer
from ..models.skeleton_classifier import SkeletonTransformer
from ..train.state import TrainState
from ..utils.checkpoint import save_checkpoint
from ..utils.weights import load_reference_checkpoint

KINDS = ("generator", "fgd", "skeleton", "cvae", "cvae_v1", "cvae_v2",
         "emotion_net")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Convert a reference torch checkpoint to a trainer "
                    "checkpoint of the PyTorch port")
    parser.add_argument("--kind", choices=KINDS, required=True)
    parser.add_argument("--input", required=True,
                        help="reference .pth file")
    parser.add_argument("--output", required=True,
                        help="directory to write checkpoint_iteration0.pt "
                             "into")
    # model geometry (must match the checkpoint; defaults = the reference
    # eval entry point's construction, test_...py:135,148-174)
    parser.add_argument("--pose_dim", type=int, default=282)
    parser.add_argument("--class_dim", type=int, default=8)
    parser.add_argument("--d_model", type=int, default=512)
    parser.add_argument("--latent_dim", type=int, default=2048)
    parser.add_argument("--gen_layers", type=int, default=3)
    parser.add_argument("--n_frames", type=int, default=60)
    parser.add_argument("--n_pre_poses", type=int, default=10)
    parser.add_argument("--chunk", type=int, default=10)
    parser.add_argument("--n_words", type=int, default=4,
                        help="generator vocab size (match the "
                             "checkpoint's embedding table)")
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--allow_pickle", action="store_true",
                        help="permit full-pickle torch.load for rich-dict "
                             "checkpoints (args/lang_model objects, "
                             "utils/train_utils.py:149-213). Unpickling "
                             "executes arbitrary code - only enable for "
                             "files you trust; plain state_dicts load "
                             "safely without this")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def build_model(args, device):
    """The module of `args.kind` at the flags' geometry."""
    if args.kind == "generator":
        return GestureTransformer(
            n_words=args.n_words, frames=args.n_frames,
            pose_dim=args.pose_dim, prior_frames=args.n_pre_poses,
            d_model=args.d_model, d_inner=args.latent_dim,
            n_layers=args.gen_layers, n_head=8, d_k=64, d_v=64,
            chunk_length=args.chunk, device=device)
    if args.kind == "fgd":
        return FGDAutoEncoder(pose_dim=args.pose_dim, device=device)
    if args.kind == "skeleton":
        return SkeletonTransformer(
            class_dim=args.class_dim, pose_dim=args.pose_dim,
            d_model=args.d_model, d_inner=args.latent_dim, n_layers=3,
            n_head=8, d_k=64, d_v=64, n_position=args.n_frames,
            device=device)
    if args.kind == "emotion_net":
        return EmotionNet(device=device)
    if args.kind == "cvae":
        return EmotionCVAEv3(feat_dim=args.d_model, device=device)
    return {"cvae_v1": EmotionCVAEv1, "cvae_v2": EmotionCVAEv2}[args.kind](
        device=device)


def main(args=None):
    """Convert; returns the checkpoint file written."""
    if args is None:
        args = build_parser().parse_args()
    device = resolve_device(args.device)
    model = build_model(args, device)
    load_reference_checkpoint(model, args.input,
                              allow_pickle=args.allow_pickle)
    state = TrainState(model, schedules.adam(model.parameters(), lr=args.lr))
    path = save_checkpoint(state, args.output)
    logging.info("converted %s -> %s", args.input, path)
    return path


def cli() -> None:
    logging.basicConfig(level=logging.INFO)
    main()


if __name__ == "__main__":
    cli()
