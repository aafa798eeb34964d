"""Trainers for the auxiliary networks the eval freezes (port of
emotiongestures_tpu/cli/train_auxiliary.py):

  --model fgd       FGD feature autoencoder (model/FGD.py)
  --model skeleton  skeleton emotion classifier (skeleton_classifer/)
  --model cvae      emotion-prior CVAE (--cvae_version 1, 2 or 3, default 3;
                    CAVE/BEAT_CVAE.py) over the
                    emotion features of a frozen generator, loaded from
                    --generator_checkpoint (a GAN trainer's
                    --model_save_path or its generator/ directory), or
                    randomly initialised without one

    python -m emotiongestures_torch.cli.train_auxiliary --model fgd \
        --train_data_path data/beat/train --batch_size 128 --total_epoch 2
    python -m emotiongestures_torch.cli.train_auxiliary --model fgd \
        --synthetic 512 --batch_size 128 --total_epoch 2
    python -m emotiongestures_torch.cli.train_auxiliary --model cvae \
        --device cpu --synthetic 16 --batch_size 8 --total_epoch 1 \
        --d_model 64 --latent_dim 128 --gen_layers 1

The training set is the GestureStore at `<train_data_path>_cache` (no
vocabulary: the text grid is zeros and the CVAE's generator has 64 words, as
in the JAX trainer), or the synthetic set with --synthetic N. Runs on the
card unless --device cpu. Checkpoints go to
<model_save_path>/<model>/ every --save_every steps and at the end, where
the eval CLI's --fgd_checkpoint / --skeleton_checkpoint / --cvae_checkpoint
read them; --resume continues from the newest. SIGTERM or SIGINT ends the
run at a step boundary with a checkpoint. A step's dropout (and the CVAE's
noise) comes from `train.gan.step_key(seed + 1, global step)`, so a resumed
run draws what an uninterrupted one would.

The skeleton classifier is built at d_model 512, as the eval CLI builds it,
with d_inner from --latent_dim and n_position from --n_poses; it keeps the
JAX defaults: 400 warmup steps, no weight decay and the plateau reseed,
which drops the plateaued attempt's checkpoint directory.

Data parallelism, one process per card, for all three models, as in the
GAN trainer (cli/train_emotion_gesture.py): --num_devices N, the multi-host
flags (--coordinator_address, --num_processes, --process_id), torchrun or
a group its caller initialised. Each rank trains on its rows of the global
batch; the CVAE's frozen generator computes each rank's features (its
TMMemory couples the global batch, as in one process); only rank 0 writes
the log and the checkpoints. Under the launcher `main` returns (None, rank
0's summary).

--cvae_version 1 or 2 trains the MLP CVAEs (models/cvae.py) on the same
features; their decoders end at 512, so they need --d_model 512 and 60
--n_poses, and refuse another --d_model. Run from the command line on the
card, the trainer turns TF32 off for its process (every trainer here is
fp32); `main()` called from other code leaves that switch to its caller.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import pprint
import shutil
import time

import torch

from ..core.device import fp32_exact_on_cuda, resolve_device
from ..data.dataset import SpeechMotionDataset
from ..data.pipeline import Prefetcher, batch_rows, place_batches
from ..data.synthetic import SyntheticGestureDataset
from ..models.generator import GestureTransformer
from ..parallel import distributed, mesh
from ..train import cvae as cvae_train
from ..train import fgd as fgd_train
from ..train import skeleton as skeleton_train
from ..train.gan import step_key
from ..utils.checkpoint import (AsyncSaver, GracefulShutdown, latest_step,
                                load_checkpoint, load_model)
from ..utils.logging import set_logger
from ..utils.profiling import StepTimer, guard_finite
from .test_emotion_gesture_diversity_iterative import N_WORDS_SYNTHETIC
from .train_emotion_gesture import add_multihost_flags

# the fields each model's step reads: the collator assembles no other
FIELDS = {"fgd": ("pose_seq",),
          "skeleton": ("pose_seq", "eid_label"),
          "cvae": ("spectrogram", "text", "pose_seq", "eid_label")}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True,
                        choices=["fgd", "skeleton", "cvae"])
    parser.add_argument("--cvae_version", type=int, default=3)
    parser.add_argument("--motion_resampling_framerate", type=int, default=15)
    parser.add_argument("--n_poses", type=int, default=60)
    parser.add_argument("--subdivision_stride", type=int, default=30)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--total_epoch", type=int, default=10)
    parser.add_argument("--pose_dim", type=int, default=282)
    parser.add_argument("--kl_beta", type=float, default=0.1)
    parser.add_argument("--model_save_path", type=str,
                        default="./checkpoints/auxiliary/")
    parser.add_argument("--generator_checkpoint", type=str, default=None,
                        help="frozen generator for CVAE feature extraction: "
                             "a GAN trainer's --model_save_path or its "
                             "generator/ checkpoint directory")
    parser.add_argument("--d_model", type=int, default=512,
                        help="generator width - must match the checkpoint "
                             "for --model cvae; also the CVAE feat_dim")
    parser.add_argument("--latent_dim", type=int, default=2048,
                        help="generator d_inner / skeleton-classifier "
                             "d_inner - match the eval CLI's --latent_dim")
    parser.add_argument("--gen_layers", type=int, default=3)
    parser.add_argument("--train_data_path", type=str,
                        default="./data/beat_trainable_dataset/train/")
    parser.add_argument("--input_context", type=str, default="text")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic samples instead of "
                             "--train_data_path's store")
    parser.add_argument("--class_overlap", type=float, default=0.0,
                        help="synthetic-set class-overlap knob "
                             "(data/synthetic.py)")
    parser.add_argument("--save_every", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num_devices", type=int, default=0,
                        help="data-parallel processes on this host, one "
                             "per card: 0 = every visible card (the largest "
                             "count that divides --batch_size)")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="host->device prefetch depth; 0 = synchronous")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the latest checkpoint under "
                             "<model_save_path>/<model>/")
    add_multihost_flags(parser)
    parser.add_argument("--plateau_patience", type=int, default=800,
                        help="skeleton only: steps without the trailing-"
                             "window mean train acc reaching --plateau_acc "
                             "before reseeding the init (0 disables); must "
                             "exceed --warmup_steps")
    parser.add_argument("--plateau_acc", type=float, default=40.0,
                        help="skeleton only: trailing-mean train-accuracy "
                             "%% that counts as out of the plateau")
    parser.add_argument("--max_reseeds", type=int, default=8,
                        help="skeleton only: bound on plateau restarts")
    parser.add_argument("--warmup_steps", type=int, default=400,
                        help="skeleton only: linear LR warmup steps (0: "
                             "constant lr)")
    parser.add_argument("--grad_clip", type=float, default=0.0,
                        help="skeleton only: global-norm gradient clip "
                             "(0 disables; negative is refused)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def _rank_main(args, exact_fp32):
    """One rank of a --num_devices run, with its launcher's TF32 setting:
    its summary (the state stays)."""
    if exact_fp32:
        fp32_exact_on_cuda()
    return main(args)[1]


def _emotion_features(args, device):
    """The frozen generator's emotion features (its second output) for CVAE
    training (SURVEY.md §3.5): built at the flags' width in eval mode, fused
    attention off, its weights from --generator_checkpoint (`<path>`, then
    `<path>/generator`). It runs under no_grad: it writes no running
    statistics and draws no dropout."""
    gen = GestureTransformer(
        n_words=N_WORDS_SYNTHETIC, frames=args.n_poses, pose_dim=args.pose_dim,
        d_model=args.d_model, d_inner=args.latent_dim,
        n_layers=args.gen_layers, device=device)
    if args.generator_checkpoint:
        path = args.generator_checkpoint
        found = [d for d in (path, os.path.join(path, "generator"))
                 if latest_step(d) is not None]
        if found:
            logging.info("loaded generator checkpoint for features: %s",
                         load_model(gen, found[0]))
        else:
            logging.warning("no generator checkpoint in %s or %s/generator: "
                            "CVAE features come from a randomly "
                            "initialised generator", path, path)
    else:
        logging.warning("no --generator_checkpoint: CVAE features come "
                        "from a randomly initialised generator")
    distributed.broadcast_module(gen)

    @torch.no_grad()
    def features(batch):
        return gen(batch["spectrogram"], batch["text"].long(),
                   batch["pose_seq"][:, :10])[1]

    return features


def _make_state(args, seed, device):
    if args.model == "fgd":
        return fgd_train.create_state(seed, lr=args.lr,
                                      pose_dim=args.pose_dim, device=device)
    if args.model == "skeleton":
        # d_model stays 512: the eval CLI builds the skeleton classifier so
        return skeleton_train.create_state(
            seed, lr=args.lr, pose_dim=args.pose_dim,
            d_inner=args.latent_dim, warmup_steps=args.warmup_steps,
            grad_clip=args.grad_clip, n_position=args.n_poses,
            device=device)
    return cvae_train.create_state(seed, lr=args.lr,
                                   version=args.cvae_version,
                                   feat_dim=args.d_model, device=device)


def main(args=None):
    """Train. Returns (state, summary); the summary holds the steps run,
    each step's time in ms (StepTimer: CUDA events on the card), the last
    step's metrics and the wall time."""
    if args is None:
        args = build_parser().parse_args()
    device = resolve_device(args.device)
    ranks = mesh.plan(args, args.batch_size, device)
    if ranks > 1 and not distributed.is_initialized():
        return None, mesh.launch(
            _rank_main, ranks, args, not torch.backends.cudnn.allow_tf32,
            device=device.type)[0]
    device = mesh.rank_device(device)
    set_logger(args.model_save_path, f"train_{args.model}.log")
    logging.info("device: %s", torch.cuda.get_device_name(device)
                 if device.type == "cuda" else device)
    logging.info(pprint.pformat(vars(args)))

    if args.synthetic:
        dataset = SyntheticGestureDataset(
            n_samples=args.synthetic, seed=args.seed, n_poses=args.n_poses,
            pose_dim=args.pose_dim, class_overlap=args.class_overlap)
    else:
        dataset = SpeechMotionDataset(
            args.train_data_path, n_poses=args.n_poses,
            subdivision_stride=args.subdivision_stride,
            pose_resampling_fps=args.motion_resampling_framerate)
    state = _make_state(args, args.seed, device)
    if ranks > 1:  # rank 0's weights on every rank
        distributed.broadcast_module(state.module)
    plateau = None
    if args.model == "fgd":
        def step(st, batch, rng):
            return fgd_train.train_step(st, batch["pose_seq"], rng)
    elif args.model == "skeleton":
        def step(st, batch, rng):
            return skeleton_train.train_step(st, batch["pose_seq"],
                                             batch["eid_label"], rng)
        if args.plateau_patience > 0:
            plateau = skeleton_train.PlateauDetector(
                patience=args.plateau_patience, acc_target=args.plateau_acc,
                max_reseeds=args.max_reseeds)
    else:
        features = _emotion_features(args, device)

        def step(st, batch, rng):
            return cvae_train.train_step(st, features(batch),
                                         batch["eid_label"], rng,
                                         beta=args.kl_beta)

    save_dir = os.path.join(args.model_save_path, args.model)
    if args.resume:
        state, ok = load_checkpoint(state, save_dir)
        if ok:
            logging.info("resumed %s from step %d", args.model, state.step)
        mesh.same_on_ranks(state.step, "the resumed step")

    def epoch_batches(epoch):
        raw = dataset.batches(args.batch_size, shuffle=True,
                              seed=args.seed + epoch,
                              fields=FIELDS[args.model],
                              rows=batch_rows(args.batch_size))
        if args.prefetch > 0:
            return Prefetcher(raw, device, buffer_size=args.prefetch)
        return contextlib.nullcontext(place_batches(raw, device))

    global_iter = state.step
    timer = StepTimer(device)
    metrics = {}
    saver = AsyncSaver()

    def save():
        if distributed.is_primary():
            saver.save(state, save_dir)
        distributed.barrier()

    start = time.time()
    with GracefulShutdown() as signals:
        # a signal that reached one rank stops every rank at the same step
        def stop():
            return mesh.any_rank(signals.requested)

        for epoch in range(args.total_epoch):
            if stop():
                break
            with epoch_batches(epoch) as batches:
                for batch in batches:
                    if stop():
                        logging.warning(
                            "shutdown requested - checkpointing at step %d "
                            "and exiting cleanly", global_iter)
                        break
                    with timer:
                        state, metrics = step(
                            state, batch, step_key(args.seed + 1,
                                                   global_iter))
                    global_iter += 1
                    if plateau is not None and \
                            plateau.update(float(metrics["acc"])):
                        # the init lottery: a fresh deterministic seed; the
                        # plateaued attempt's checkpoints are chance-level
                        # and are dropped, so resume and eval never read one
                        logging.warning(
                            "skeleton init-lottery plateau: trailing-mean "
                            "train acc never reached %.1f%% in %d steps - "
                            "reseeding (attempt %d/%d)", args.plateau_acc,
                            args.plateau_patience, plateau.attempts,
                            args.max_reseeds)
                        state = _make_state(args, plateau.next_key(args.seed),
                                            device)
                        if ranks > 1:
                            distributed.broadcast_module(state.module)
                        if distributed.is_primary():
                            saver.wait()
                            shutil.rmtree(save_dir, ignore_errors=True)
                        distributed.barrier()
                    if global_iter % 10 == 0:
                        m = {k: float(v) for k, v in metrics.items()}
                        guard_finite(m, "train metrics")
                        logging.info("epoch %d iter %d %s [%.1fs]", epoch,
                                     global_iter,
                                     {k: round(v, 4) for k, v in m.items()},
                                     time.time() - start)
                    if global_iter % args.save_every == 0:
                        save()
        save()
        saver.close()  # the final checkpoint is on disk
        distributed.barrier()
    wall_s = time.time() - start
    logging.info("done: %d iters in %.1fs%s", global_iter, wall_s,
                 " (clean shutdown on signal)" if signals.requested else "")
    summary = {"steps": global_iter, "step_ms": timer.times_ms(),
               "metrics": {k: float(v) for k, v in metrics.items()},
               "wall_s": wall_s, "device": str(device), "ranks": ranks}
    return state, summary


def cli() -> None:
    """Command-line entry point (main's return value is not an exit
    status). The CLI owns this process, so it runs on the card with TF32
    off."""
    args = build_parser().parse_args()
    if resolve_device(args.device).type == "cuda":
        fp32_exact_on_cuda()
    main(args)


if __name__ == "__main__":
    cli()
