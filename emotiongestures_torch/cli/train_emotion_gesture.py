"""GAN trainer for the gesture generator (port of
emotiongestures_tpu/cli/train_emotion_gesture.py, the reconstruction of the
reference's unreleased train.py): Adam(lr 2e-4, betas (0.5, 0.999)) on the
staged LR ladder, loss_regression_weight 100, the pose_dis_warm_epoch
warm-up, the motion discriminator, the emotion CE head and the InfoNCE
disentanglement term (train/gan.py).

    python -m emotiongestures_torch.cli.train_emotion_gesture \
        --train_data_path data/beat/train --batch_size 128 --total_epoch 2 \
        [--preset fast]
    python -m emotiongestures_torch.cli.train_emotion_gesture \
        --synthetic 512 --batch_size 128 --total_epoch 2 [--preset fast]
    python -m emotiongestures_torch.cli.train_emotion_gesture --device cpu \
        --synthetic 16 --batch_size 8 --total_epoch 1 --d_model 64 \
        --latent_dim 128 --gen_layers 1

The training set is the GestureStore at `<train_data_path>_cache`, read in
a seeded shuffle through the C++ batch gather (the JAX trainer's order), with
the vocabulary built from its words (GANConfig.n_words is its size);
--synthetic N trains on the synthetic set instead. Runs on the card unless
--device cpu. Checkpoints go to --model_save_path
(`generator/` and `discriminator/`, every --save_every steps and at the
end); --resume continues from the newest, and the staged LR and the
discriminator warm-up follow the global epoch (restored step //
steps_per_epoch). SIGTERM or SIGINT ends the run at a step boundary with a
checkpoint. --profile_dir writes a torch.profiler Chrome trace of
--profile_steps steps from the fourth step of the run on.

Data parallelism, one process per card (parallel/): --num_devices N > 1
starts N processes on this host, one per card (0, the default, is every
visible card, degraded to the largest count that divides --batch_size);
--coordinator_address host:port --num_processes P --process_id i joins P
processes on several hosts, each on the card of its local rank; under
torchrun, or in a process whose caller has initialised the group, `main`
joins that group. Each rank trains on its rows of the global batch with
global-batch semantics (parallel/mesh.py); only rank 0 writes the log,
metrics.jsonl and the checkpoints, and every rank resumes from the same
step. Under the launcher `main` returns (None, None, rank 0's summary): the
states live in the ranks.

Tensor parallelism: --model_parallel M with --num_devices N starts N
processes on this host as an (N / M) x M data x model grid (the JAX
package's `devices.reshape(n_data, n_model)`; M must divide N, the batch
must divide over N / M). The generator's and the discriminator's FFN and
MHA weights and their Adam moments are split over each model group by the
JAX package's rules (parallel/tensor.py), everything else is replicated,
and a step equals one process's on the global batch. Checkpoints are
written whole (the one-process layout), and --resume onto a grid cuts
what it loads. Single-host only: with the multi-host flags it is refused.

--variant memory|base|spatial_memory|padding_initial picks the generator's
prior encoder (models/generator.py); a --resume continues a run of the same
--variant, and the checkpoint of another variant fails its strict load.
Run from the command line in fp32 on the card, the trainer turns TF32 off
for its process; `main()` called from other code leaves that switch to its
caller.
"""
from __future__ import annotations

import contextlib
import logging
import os
import pprint
import sys
import time

import torch

from ..core.device import fp32_exact_on_cuda, resolve_device
from ..core.schedules import staged_lr
from ..data.dataset import SpeechMotionDataset
from ..data.pipeline import Prefetcher, batch_rows, place_batches
from ..data.synthetic import SyntheticGestureDataset
from ..data.vocab import build_vocab
from ..parallel import distributed, mesh, tensor
from ..train import gan
from ..utils.checkpoint import AsyncSaver, GracefulShutdown, load_checkpoint
from ..utils.logging import MetricLogger, set_logger
from ..utils.profiling import StepTimer, guard_finite, trace
from ..utils.weights import jax_table
from .presets import GAN_TRAIN_FAST, apply_preset
from .test_emotion_gesture_diversity_iterative import (
    N_WORDS_SYNTHETIC,
    _str2bool,
)
from .test_emotion_gesture_diversity_iterative import (
    build_parser as eval_parser,
)

BATCH_KEYS = ("spectrogram", "text", "pose_seq", "eid_label")


def build_parser():
    parser = eval_parser()  # the same flag surface as the eval CLI
    parser.add_argument("--model_save_path", type=str,
                        default="./checkpoints/fullmodel_emotion_gesture/")
    parser.add_argument("--save_every", type=int, default=100)
    parser.add_argument("--variant", type=str, default="memory",
                        choices=["memory", "base", "spatial_memory",
                                 "padding_initial"])
    parser.add_argument("--loss_gan_weight", type=float, default=1.0)
    parser.add_argument("--loss_emotion_weight", type=float, default=1.0)
    parser.add_argument("--loss_contrastive_weight", type=float, default=0.1)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="bfloat16: fp32 master weights and Adam state, "
                             "forward and backward on a bf16 copy")
    parser.add_argument("--update_order", type=str, default="d_first",
                        choices=["d_first", "g_first"],
                        help="g_first shares one generator forward between "
                             "both updates (G's adversarial term sees the "
                             "pre-update D); see train/gan.py")
    parser.add_argument("--d_concat_batch", type=_str2bool, default=False,
                        help="the discriminator's real and fake passes as "
                             "one 2B batch (it has no BatchNorm: only the "
                             "dropout draws differ)")
    parser.add_argument("--grad_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="bfloat16: gradients of the bf16 copy, upcast "
                             "at Adam; requires --compute_dtype bfloat16")
    parser.add_argument("--cast_inputs", type=_str2bool, default=False,
                        help="cast float32 batch arrays to bfloat16 on the "
                             "host before the copy to the card (halves the "
                             "bytes; quantizes the regression target); "
                             "requires --compute_dtype bfloat16")
    parser.add_argument("--data_echo", type=int, default=1,
                        help="step each batch E times (fresh dropout draws "
                             "per echo); E multiplies the steps per epoch")
    add_multihost_flags(parser)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace of "
                             "--profile_steps steps, from the fourth step of "
                             "this run on, into this directory")
    parser.add_argument("--profile_steps", type=int, default=5)
    return parser


def add_multihost_flags(parser) -> None:
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="multi-host runs: host:port of process 0")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="multi-host runs: processes in all, one per "
                             "card")
    parser.add_argument("--process_id", type=int, default=None,
                        help="multi-host runs: this process's index")


def _rank_main(args, exact_fp32):
    """One rank of a --num_devices run, with its launcher's TF32 setting:
    its summary (the states stay)."""
    if exact_fp32:
        fp32_exact_on_cuda()
    return main(args)[2]


def main(args=None):
    """Train. Returns (gen_state, disc_state, summary); the summary holds
    the steps run, each step's time in ms (StepTimer: CUDA events on the
    card), the last step's metrics and the wall time."""
    argv = sys.argv[1:] if args is None else None
    if args is None:
        args = build_parser().parse_args()
    args = apply_preset(args, build_parser(), GAN_TRAIN_FAST, argv=argv)
    device = resolve_device(args.device)
    if args.cast_inputs and args.compute_dtype != "bfloat16":
        raise SystemExit("--cast_inputs requires --compute_dtype bfloat16")
    if args.data_echo < 1:
        raise SystemExit("--data_echo must be >= 1")
    if args.model_parallel > 1 and mesh.multihost(args):
        raise SystemExit("--model_parallel is single-host only "
                         "(combine with --num_devices, not "
                         "--coordinator_address)")
    ranks = mesh.plan(args, args.batch_size, device)
    if ranks > 1 and not distributed.is_initialized():
        return None, None, mesh.launch(
            _rank_main, ranks, args, not torch.backends.cudnn.allow_tf32,
            device=device.type)[0]
    device = mesh.rank_device(device)
    set_logger(args.model_save_path, "train_emotion_gesture.log")
    logging.info("device: %s", torch.cuda.get_device_name(device)
                 if device.type == "cuda" else device)
    n_data, n_model = distributed.data_count(), distributed.model_count()
    if n_model > 1:
        logging.info("data x model mesh: %s (global batch %d -> %d/chip)",
                     {"data": n_data, "model": n_model}, args.batch_size,
                     args.batch_size // n_data)
    elif ranks > 1:
        logging.info("data parallel: %d processes, global batch %d -> %d "
                     "per rank", ranks, args.batch_size,
                     args.batch_size // ranks)
    logging.info(pprint.pformat(vars(args)))

    if args.synthetic:
        dataset = SyntheticGestureDataset(
            n_samples=args.synthetic, seed=args.seed, n_poses=args.n_frames,
            pose_dim=args.pose_dim, class_overlap=args.class_overlap)
        n_words = N_WORDS_SYNTHETIC
    else:
        dataset = SpeechMotionDataset(
            args.train_data_path, n_poses=args.n_poses,
            subdivision_stride=args.subdivision_stride,
            pose_resampling_fps=args.motion_resampling_framerate,
            remove_word_timing=(args.input_context == "text"))
        lang_model = build_vocab("words", [dataset.store], None,
                                 args.wordembed_path, args.wordembed_dim)
        dataset.set_lang_model(lang_model)
        n_words = lang_model.n_words
    # one epoch is one pass over the data; echo steps count toward it, so
    # the staged ladder still advances per data epoch
    steps_per_epoch = max(len(dataset) // args.batch_size, 1) * \
        args.data_echo
    cfg = gan.GANConfig(
        n_words=n_words, frames=args.n_frames,
        pose_dim=args.pose_dim, prior_frames=args.n_pre_poses,
        d_model=args.d_model, d_inner=args.latent_dim,
        n_layers=args.gen_layers, steps_per_epoch=steps_per_epoch,
        lr=args.lr, beta1=args.beta1, beta2=args.beta2,
        loss_regression_weight=float(args.loss_regression_weight),
        loss_gan_weight=args.loss_gan_weight,
        loss_emotion_weight=args.loss_emotion_weight,
        loss_contrastive_weight=args.loss_contrastive_weight,
        variant=args.variant, compute_dtype=args.compute_dtype,
        update_order=args.update_order,
        d_concat_batch=args.d_concat_batch, grad_dtype=args.grad_dtype)
    gen_state, disc_state = gan.create_states(cfg, args.seed, device)
    if ranks > 1:  # rank 0's weights on every rank
        distributed.broadcast_module(gen_state.module)
        distributed.broadcast_module(disc_state.module)
    gen_dir = os.path.join(args.model_save_path, "generator")
    disc_dir = os.path.join(args.model_save_path, "discriminator")
    if args.resume:
        gen_state, ok = load_checkpoint(gen_state, gen_dir, table=jax_table(
            "generator", n_layers=args.gen_layers, variant=args.variant))
        disc_state, _ = load_checkpoint(
            disc_state, disc_dir, table=jax_table("motion_discriminator"))
        if ok:
            logging.info("resumed from step %d", gen_state.step)
        mesh.same_on_ranks(gen_state.step, "the resumed step")
    # the FFN and MHA weights and their Adam moments split over the model
    # group, after a resume has loaded them whole
    for state in (gen_state, disc_state):
        tensor.shard_train_state(state, distributed.model_index(), n_model)
    float_dtype = torch.bfloat16 if args.cast_inputs else None

    def epoch_batches(epoch):
        """Batches through the host prefetcher: assembly, the optional
        bf16 cast and the copy to the card overlap the step."""
        raw = dataset.batches(args.batch_size, shuffle=True,
                              seed=args.seed + epoch, fields=BATCH_KEYS,
                              rows=batch_rows(args.batch_size))
        if args.prefetch > 0:
            return Prefetcher(raw, device, buffer_size=args.prefetch,
                              float_dtype=float_dtype)
        return contextlib.nullcontext(
            place_batches(raw, device, float_dtype=float_dtype))

    saver = AsyncSaver()

    def save_all():
        gen, disc = gen_state, disc_state
        if n_model > 1:  # the shards gathered, on every rank of the grid
            gen, disc = tensor.whole_tree(gen), tensor.whole_tree(disc)
        if distributed.is_primary():
            saver.save(gen, gen_dir)
            saver.save(disc, disc_dir)
        distributed.barrier()

    ladder = staged_lr(args.lr)
    metrics_log = MetricLogger(
        os.path.join(args.model_save_path, "metrics.jsonl"))
    global_iter = gen_state.step
    # --profile_dir: a steady-state window from the fourth step of this run
    profile_at = global_iter + 3 if args.profile_dir else None
    tracer = None
    trace_started = False
    timer = StepTimer(device)
    last = {}
    start = time.time()
    with GracefulShutdown() as signals:
        # a signal that reached one rank stops every rank at the same step
        def stop():
            return mesh.any_rank(signals.requested)

        for epoch in range(args.total_epoch):
            if stop():
                break
            # epoch-indexed decisions follow the global epoch, as the
            # optimizer's ladder does: after --resume the loop restarts
            # at 0, which would log a stale LR and rerun the warm-up
            global_epoch = global_iter // max(steps_per_epoch, 1)
            lr_now = ladder(global_epoch)
            use_disc = global_epoch >= args.pose_dis_warm_epoch
            with epoch_batches(epoch) as batches:
                for batch in batches:
                    if stop():
                        logging.warning(
                            "shutdown requested - checkpointing at step %d "
                            "and exiting cleanly", global_iter)
                        break
                    for _echo in range(args.data_echo):
                        if global_iter == profile_at:
                            tracer = trace(args.profile_dir)
                            tracer.__enter__()
                            trace_started = True
                        with timer:
                            gen_state, disc_state, last = gan.train_step(
                                gen_state, disc_state, batch,
                                gan.step_key(args.seed + 1, global_iter),
                                cfg, use_disc=use_disc)
                        global_iter += 1
                        if tracer is not None and global_iter >= \
                                profile_at + args.profile_steps:
                            tracer.__exit__(None, None, None)
                            tracer = None
                        if global_iter % 10 == 0:
                            m = {k: float(v) for k, v in last.items()}
                            guard_finite(m, "train metrics")
                            logging.info(
                                "epoch %d iter %d lr %.2e g %.4f (rec %.4f "
                                "emo %.4f con %.4f adv %.4f) d %.4f "
                                "[%.1fs]", epoch, global_iter, lr_now,
                                m["g_loss"], m["g_rec"], m["g_emo"],
                                m["g_con"], m["g_adv"], m["d_loss"],
                                time.time() - start)
                            metrics_log.log(global_iter, **m)
                        if global_iter % args.save_every == 0:
                            save_all()
        if tracer is not None:  # the run ended inside the window
            tracer.__exit__(None, None, None)
        if profile_at is not None and not trace_started:
            logging.warning(
                "--profile_dir was set but the run ended before the trace "
                "window opened (needs more than %d steps past the resume "
                "point; ran to step %d): no trace was written",
                profile_at, global_iter)
        save_all()
        saver.close()  # the final checkpoint is on disk
        distributed.barrier()
    wall_s = time.time() - start
    logging.info("done: %d iters in %.1fs%s", global_iter, wall_s,
                 " (clean shutdown on signal)" if signals.requested else "")
    summary = {"steps": global_iter, "step_ms": timer.times_ms(),
               "metrics": {k: float(v) for k, v in last.items()},
               "wall_s": wall_s, "device": str(device), "ranks": ranks}
    return gen_state, disc_state, summary


def cli() -> None:
    """Command-line entry point (main's return value is not an exit
    status). The CLI owns this process, so fp32 runs on the card with TF32
    off."""
    argv = sys.argv[1:]
    args = apply_preset(build_parser().parse_args(argv), build_parser(),
                        GAN_TRAIN_FAST, argv=argv)
    if args.compute_dtype == "float32" and \
            resolve_device(args.device).type == "cuda":
        fp32_exact_on_cuda()
    main(args)


if __name__ == "__main__":
    cli()
