"""Audio emotion classifier K-fold trainer (port of
emotiongestures_tpu/cli/train_audio_classifier_K_fold.py), flag-compatible
with the reference's train_audio_classifier_K_fold.py:309-331.

    python -m emotiongestures_torch.cli.train_audio_classifier_K_fold \
        --train_data_path data/beat/train --val_data_path data/beat/val \
        --test_data_path data/beat/test --batch_size 128 --total_epoch 2 \
        --max_folds 1 [--preset fast]
    python -m emotiongestures_torch.cli.train_audio_classifier_K_fold \
        --synthetic 512 --batch_size 128 --total_epoch 2 --max_folds 1 \
        [--preset fast]

The folds split the train and val stores together (each a GestureStore at
`<path>_cache`); the test store is the held-out set.

Extra flags, as in the JAX CLI: --synthetic N (the deterministic synthetic
set), --class_overlap, --max_folds / --eval_every to bound a run, --resume
(the newest checkpoint in --model_save_path and its kfold_progress.json:
earlier folds are skipped and the interrupted fold resumes mid-epoch on the
replayed permutation), --seed, --compute_dtype, --prefetch, --preset
(`fast`: --compute_dtype bfloat16) and --device. Each finished fold's
confusion matrix is drawn to confusion_fold<k>.png when matplotlib is
installed; without it a warning is logged and training is unaffected.

Runs on the card unless --device cpu. --num_devices N trains data-parallel
over N processes on this host, one per card (0, the default, is every
visible card, degraded to the largest count that divides --batch_size);
under torchrun, or in a process whose caller has initialised the group,
`main` joins that group. Every rank walks the same folds and permutations
and trains on its rows of each batch (train/classifier.py); only rank 0
writes the log, the checkpoints, kfold_progress.json and the confusion
plots, and every rank resumes from the same step. Under the launcher
`main` returns rank 0's records without their "state" (None): the states
live in the ranks. Run from the command line in fp32 on the card, the
trainer turns TF32 off for its process; `main()` called from other code
leaves that switch to its caller.
"""
from __future__ import annotations

import argparse
import json
import logging
import pprint
import sys
from pathlib import Path

import torch

from ..core.device import fp32_exact_on_cuda, resolve_device
from ..data.dataset import SpeechMotionDataset
from ..data.synthetic import SyntheticGestureDataset
from ..parallel import distributed, mesh
from ..train import classifier
from ..utils.checkpoint import (GracefulShutdown, load_checkpoint,
                                save_checkpoint)
from ..utils.logging import set_logger
from ..utils.weights import jax_table
from .presets import CLASSIFIER_FAST, add_preset_flag, apply_preset


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    # reference flags (train_...py:309-331), names and defaults kept
    parser.add_argument("--motion_resampling_framerate", type=int, default=15)
    parser.add_argument("--n_poses", type=int, default=60)
    parser.add_argument("--n_pre_poses", type=int, default=15)
    parser.add_argument("--subdivision_stride", type=int, default=30)
    parser.add_argument("--loader_workers", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.0003)
    parser.add_argument("--beta1", type=float, default=0.5)
    parser.add_argument("--beta2", type=float, default=0.999)
    parser.add_argument("--total_epoch", type=int, default=60)
    parser.add_argument("--pose_dim", type=int, default=4)
    parser.add_argument(
        "--model_save_path", type=str,
        default="./checkpoints/audio_emotion_classifer_10_fold_v1")
    parser.add_argument("--latent_dim", type=int, default=128)
    parser.add_argument("--wordembed_path", type=str, default=None)
    parser.add_argument("--wordembed_dim", type=int, default=300)
    parser.add_argument("--input_context", type=str, default="text")
    parser.add_argument("--train_data_path", type=str,
                        default="./data/BEAT_Emotion/train/")
    parser.add_argument("--val_data_path", type=str,
                        default="./data/BEAT_Emotion/val/")
    parser.add_argument("--test_data_path", type=str,
                        default="./data/BEAT_Emotion/test/")
    # extras
    parser.add_argument("--synthetic", type=int, default=0,
                        help="use N synthetic samples instead of the "
                             "train, val and test stores")
    parser.add_argument("--class_overlap", type=float, default=0.0,
                        help="synthetic-set class-overlap knob "
                             "(data/synthetic.py)")
    parser.add_argument("--max_folds", type=int, default=None)
    parser.add_argument("--eval_every", type=int, default=100)
    parser.add_argument("--resume", action="store_true",
                        help="continue from the latest checkpoint in "
                             "--model_save_path: earlier folds are skipped "
                             "and the interrupted fold resumes mid-epoch on "
                             "the replayed permutation")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="bfloat16: fp32 master weights and Adam state, "
                             "forward and backward on a bf16 copy")
    parser.add_argument("--num_devices", type=int, default=0,
                        help="data-parallel processes on this host, one "
                             "per card: 0 = every visible card (the largest "
                             "count that divides --batch_size)")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="host->device prefetch depth (pinned memory, "
                             "a side CUDA stream); 0 = synchronous")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    add_preset_flag(parser)
    return parser


class _ConcatDataset:
    """The train and val stores as one indexable set (the K-fold split
    runs over both)."""

    def __init__(self, datasets):
        self.datasets = datasets
        self._lens = [len(d) for d in datasets]

    def __len__(self):
        return sum(self._lens)

    def __getitem__(self, idx):
        for d, n in zip(self.datasets, self._lens):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError


def _rank_main(args, exact_fp32):
    """One rank of a --num_devices run, with its launcher's TF32 setting:
    its records without the states."""
    if exact_fp32:
        fp32_exact_on_cuda()
    return [{**r, "state": None} for r in main(args)]


def main(args=None):
    """Train. Returns train_k_fold's records, one per finished fold (fold,
    test_acc, confusion, state and each step's time in ms)."""
    argv = sys.argv[1:] if args is None else None
    if args is None:
        args = build_parser().parse_args()
    args = apply_preset(args, build_parser(), CLASSIFIER_FAST, argv=argv)
    device = resolve_device(args.device)
    ranks = mesh.plan(args, args.batch_size, device)
    if ranks > 1 and not distributed.is_initialized():
        return mesh.launch(_rank_main, ranks, args,
                           not torch.backends.cudnn.allow_tf32,
                           device=device.type)[0]
    device = mesh.rank_device(device)
    set_logger(args.model_save_path, "train_audio_classifier_K_fold.log")
    logging.info("device: %s", torch.cuda.get_device_name(device)
                 if device.type == "cuda" else device)
    logging.info(pprint.pformat(vars(args)))

    if args.synthetic:
        full = SyntheticGestureDataset(n_samples=args.synthetic,
                                       seed=args.seed,
                                       class_overlap=args.class_overlap)
        test = SyntheticGestureDataset(
            n_samples=max(args.batch_size, args.synthetic // 4),
            seed=args.seed + 1, class_overlap=args.class_overlap)
    else:
        def store(path):
            return SpeechMotionDataset(
                path, n_poses=args.n_poses,
                subdivision_stride=args.subdivision_stride,
                pose_resampling_fps=args.motion_resampling_framerate,
                remove_word_timing=(args.input_context == "text"))

        full = _ConcatDataset([store(args.train_data_path),
                               store(args.val_data_path)])
        test = store(args.test_data_path)
    save_dir = Path(args.model_save_path)
    progress_path = save_dir / "kfold_progress.json"

    def checkpoint_fn(state, fold, epoch, it):
        # the newest only: at (128, 124) the net and Adam's moments are
        # 3.4 GB a checkpoint, and --resume reads the newest
        if distributed.is_primary():
            path = save_checkpoint(state, save_dir, max_to_keep=1)
            progress_path.write_text(json.dumps(
                {"fold": fold, "epoch": epoch, "iter": it}))
            logging.info("saved %s (fold %d epoch %d iter %d)", path,
                         fold + 1, epoch, it)
        distributed.barrier()

    resume_from = None
    if args.resume:
        template = classifier.create_state(
            args.seed, lr=args.lr,
            spec_shape=full[0]["spectrogram"].shape, device=device)
        state, ok = load_checkpoint(template, save_dir,
                                    table=jax_table("emotion_net"))
        mesh.same_on_ranks(state.step, "the resumed step")
        if ok and progress_path.exists():
            fold = json.loads(progress_path.read_text())["fold"]
            resume_from = (state, fold)
            logging.info("resuming fold %d from iter %d", fold + 1,
                         state.step)
        else:
            logging.warning("--resume: no checkpoint/progress found in %s - "
                            "starting fresh", save_dir)

    with GracefulShutdown() as signals:
        results = classifier.train_k_fold(
            full, test, batch_size=args.batch_size, epochs=args.total_epoch,
            lr=args.lr, eval_every=args.eval_every, seed=args.seed,
            max_folds=args.max_folds, checkpoint_fn=checkpoint_fn,
            compute_dtype=args.compute_dtype, prefetch=args.prefetch,
            # a signal that reached one rank stops every rank at one step
            should_stop=lambda: mesh.any_rank(signals.requested),
            resume_from=resume_from,
            device=device)
    for r in results if distributed.is_primary() else ():
        logging.info("Fold %d: Test Accuracy %.2f%%", r["fold"] + 1,
                     r["test_acc"])
        cm_path = str(save_dir / f"confusion_fold{r['fold'] + 1}.png")
        try:
            classifier.vis_confusion_matrix(r["confusion"], cm_path)
            logging.info("confusion matrix -> %s", cm_path)
        except Exception as exc:  # an artefact only: no matplotlib, backend
            logging.warning("confusion-matrix plot failed: %s", exc)
    return results


def cli() -> None:
    """Command-line entry point (main's return value is not an exit
    status). The CLI owns this process, so fp32 runs on the card with TF32
    off."""
    argv = sys.argv[1:]
    args = apply_preset(build_parser().parse_args(argv), build_parser(),
                        CLASSIFIER_FAST, argv=argv)
    if args.compute_dtype == "float32" and \
            resolve_device(args.device).type == "cuda":
        fp32_exact_on_cuda()
    main(args)


if __name__ == "__main__":
    cli()
