"""Diverse-generation evaluation CLI (port of
emotiongestures_tpu/cli/test_emotion_gesture_diversity_iterative.py), flag-
compatible with the reference's test_emotion_gesture_diversity_iterative.py:
345-377.

    python -m emotiongestures_torch.cli.test_emotion_gesture_diversity_iterative \
        --test_data_path data/beat/test --test_batch_size 1024 --preset fast
    python -m emotiongestures_torch.cli.test_emotion_gesture_diversity_iterative \
        --synthetic 2048 --test_batch_size 1024 --preset fast

The test set is the GestureStore at `<test_data_path>_cache` (made by
data.preprocessing.DataPreprocessor or data.synthetic.materialize_store),
read in order through the C++ batch gather; the vocabulary is built from
its words and cached at `vocab_all.pkl` beside `test_data_path`, in the
pickle both packages read. --synthetic N evaluates on the synthetic set
instead.

Per batch, `eval_batch` runs on the card: a CVAE prior sample, the
generator, the skeleton classifier's logits of the generated poses, the FGD
autoencoder's features of the poses and of the target, and the rotation
error. Under --precision bfloat16 the generator and CVAE run in bf16; the
metric nets always run in fp32. --fused_attention sends the generator's six
attention sublayers through the CUDA kernel. On the host: Emotion-Acc, L2,
beat alignment (its onset frontend on the card with --device_beat) and, at
the end, the Fréchet distance and the diversity score, with the reference's
summary line. `--num_diversity_passes N` adds N - 1 passes with fresh CVAE
noise, pooled into the diversity estimate only.

Runs on the card unless --device cpu. The checkpoint flags take
reference-layout .pth files (a `module.` prefix and a `gen_dict` wrapper are
stripped), the checkpoint directories of the port's trainers (the newest
`checkpoint_iteration<N>.pt`), or the JAX package's orbax checkpoints (a
`checkpoint_iteration<N>` directory, or the directory holding them: the
newest; read by utils/orbax.py without jax or tensorstore). For the
generator, `<path>` or `<path>/generator`, so --checkpoints_folder_path may
name either package's GAN --model_save_path. Without one, a net keeps its
seeded random weights.

--num_devices N evaluates data-parallel over N processes on this host, one
per card (0, the default, is every visible card, degraded to the largest
count that divides --test_batch_size); under torchrun, or in a process
whose caller has initialised the group, `main` joins that group. Each rank
runs `eval_batch` on its rows of every batch (the CVAE noise is its rows of
the global draw, TMMemory couples the global batch), scores beat alignment,
accuracy and L2 on its rows, and the FGD features are gathered, so the
Fréchet distance and the diversity score are computed once on rank 0 from
the global batch. Rank 0 returns the summary of a one-process run; the
other ranks return only their `timings`. Under the launcher `main` returns
rank 0's summary.

Not ported yet, and refused with an error: --model_parallel > 1 (tensor
parallelism, ROADMAP.md queue 1, item 6b). Run from the command line with --precision
float32 on the card, the CLI turns TF32 off for its process; `main()`
called from other code leaves that switch to its caller.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import logging
import os
import pprint
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import precision as prec
from ..core.device import fp32_exact_on_cuda, resolve_device
from ..data.dataset import SpeechMotionDataset
from ..data.pipeline import Prefetcher, batch_rows, place_batches
from ..data.synthetic import SyntheticGestureDataset
from ..data.vocab import build_vocab
from ..eval.beat import BeatAligner
from ..eval.fgd import diversity_score, frechet_from_features
from ..eval.metrics import compute_acc, l2_distance_pose
from ..models.cvae import EmotionCVAEv3
from ..models.fgd_ae import FGDAutoEncoder
from ..models.generator import GestureTransformer
from ..models.skeleton_classifier import SkeletonTransformer
from ..parallel import distributed, mesh
from ..utils.logging import set_logger
from ..utils.weights import jax_table, load_reference_checkpoint
from .presets import EVAL_FAST, add_preset_flag, apply_preset

N_WORDS_SYNTHETIC = 64
FEAT_DIM = 512  # the FGD autoencoder's latent width


def _str2bool(value: str) -> bool:
    """Boolean flag parser with correct string semantics (the reference's
    `type=bool` parses `--freeze_wordembed False` as True)."""
    lowered = value.strip().lower()
    if lowered in ("true", "1", "yes", "y", "on"):
        return True
    if lowered in ("false", "0", "no", "n", "off", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {value!r}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    # reference flags (test_...py:345-377)
    parser.add_argument("--motion_resampling_framerate", type=int, default=15)
    parser.add_argument("--n_poses", type=int, default=60)
    parser.add_argument("--n_frames", type=int, default=60)
    parser.add_argument("--n_pre_poses", type=int, default=10)
    parser.add_argument("--class_dim", type=int, default=8)
    parser.add_argument("--chunk", type=int, default=10)
    parser.add_argument("--subdivision_stride", type=int, default=30)
    parser.add_argument("--loader_workers", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--test_batch_size", type=int, default=1024)
    parser.add_argument("--lr", type=float, default=0.0002)
    parser.add_argument("--beta1", type=float, default=0.5)
    parser.add_argument("--beta2", type=float, default=0.999)
    parser.add_argument("--pose_dis_warm_epoch", type=int, default=0)
    parser.add_argument("--loss_regression_weight", type=int, default=100)
    parser.add_argument("--dropout_prob", type=float, default=0.1)
    parser.add_argument("--freeze_wordembed", type=_str2bool, default=False)
    parser.add_argument("--hidden_size", type=int, default=300)
    parser.add_argument("--n_layers", type=int, default=3)
    parser.add_argument("--total_epoch", type=int, default=100)
    parser.add_argument("--pose_dim", type=int, default=282)
    parser.add_argument("--log_save_path", type=str,
                        default="./logs/diversity_eval/")
    parser.add_argument("--latent_dim", type=int, default=2048)
    parser.add_argument("--wordembed_path", type=str, default=None)
    parser.add_argument("--wordembed_dim", type=int, default=300)
    parser.add_argument("--input_context", type=str, default="text")
    parser.add_argument("--train_data_path", type=str,
                        default="./data/beat_trainable_dataset/train/")
    parser.add_argument("--val_data_path", type=str,
                        default="./data/beat_trainable_dataset/val/")
    parser.add_argument("--test_data_path", type=str,
                        default="./data/beat_trainable_dataset/test/")
    # framework extras
    parser.add_argument("--synthetic", type=int, default=0,
                        help="evaluate on N synthetic samples instead "
                             "of --test_data_path's store")
    parser.add_argument("--class_overlap", type=float, default=0.0,
                        help="synthetic-set class overlap: blends each "
                             "sample's postural class signature toward the "
                             "next class by U(0, overlap), see "
                             "data/synthetic.py")
    parser.add_argument("--checkpoints_folder_path", type=str, default=None,
                        help="generator .pth (reference layout), or the GAN "
                             "trainer's checkpoint directory")
    parser.add_argument("--fgd_checkpoint", type=str, default=None)
    parser.add_argument("--skeleton_checkpoint", type=str, default=None)
    parser.add_argument("--cvae_checkpoint", type=str, default=None)
    parser.add_argument("--n_words", type=int, default=64)
    parser.add_argument("--d_model", type=int, default=512,
                        help="generator width (match your checkpoint)")
    parser.add_argument("--gen_layers", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--skip_beat", action="store_true",
                        help="skip beat alignment")
    parser.add_argument("--allow_pickle", action="store_true",
                        help="permit full-pickle torch.load of a checkpoint "
                             "that holds more than tensors (it runs code "
                             "from the file: only for trusted files)")
    parser.add_argument("--precision", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="bfloat16 runs the generator and CVAE in bf16; "
                             "the metric nets stay fp32")
    parser.add_argument("--fused_attention", action="store_true",
                        help="send the generator's attention sublayers "
                             "through the fused CUDA kernel")
    parser.add_argument("--device_beat", action="store_true",
                        help="compute the beat metric's onset envelopes and "
                             "frame RMS in one pass on the card per batch")
    parser.add_argument("--num_diversity_passes", type=int, default=1,
                        help="CVAE-noise passes pooled into the diversity "
                             "estimate (the reference's 'iterative' re-runs)")
    parser.add_argument("--num_devices", type=int, default=0,
                        help="data-parallel processes on this host, one "
                             "per card: 0 = every visible card (the largest "
                             "count that divides --test_batch_size)")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="host->device prefetch depth (pinned memory, "
                             "a side CUDA stream); 0 = synchronous")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="1: tensor parallelism is not ported")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    add_preset_flag(parser)
    return parser


@dataclass
class EvalNets:
    gen: GestureTransformer
    fgd: FGDAutoEncoder
    skeleton: SkeletonTransformer
    vae: EmotionCVAEv3
    dtype: torch.dtype      # the generator's and CVAE's compute dtype
    n_pre_poses: int
    loaded: dict            # net -> the checkpoint file read, or None


def _load(module, path, name, allow_pickle, table, subdir=None):
    """Load `path` into `module` (`table`: its JAX weight table, for an
    orbax checkpoint); returns what was read, or None (random weights)
    without a path."""
    if path:
        read = load_reference_checkpoint(module, path, allow_pickle, subdir,
                                         table)
        logging.info("loaded %s checkpoint from %s", name, read)
        return str(read)
    logging.warning("no %s checkpoint: using randomly initialised "
                    "weights", name)
    return None


def build_models(args, n_words: int, device) -> EvalNets:
    """The four nets of the eval, seeded from --seed, checkpoints loaded,
    the generator and CVAE cast for --precision."""
    torch.manual_seed(args.seed)
    gen = GestureTransformer(
        n_words=n_words, frames=args.n_frames, pose_dim=args.pose_dim,
        prior_frames=args.n_pre_poses, d_model=args.d_model,
        d_inner=args.latent_dim, n_layers=args.gen_layers, n_head=8, d_k=64,
        d_v=64, chunk_length=args.chunk, text_dropout=args.dropout_prob,
        fused_attention=args.fused_attention, device=device)
    fgd = FGDAutoEncoder(pose_dim=args.pose_dim, latent_dim=FEAT_DIM,
                         device=device)
    skeleton = SkeletonTransformer(
        class_dim=args.class_dim, pose_dim=args.pose_dim, d_model=512,
        d_inner=args.latent_dim, n_layers=3, n_head=8, d_k=64, d_v=64,
        n_position=60, device=device)
    vae = EmotionCVAEv3(feat_dim=args.d_model, device=device)
    loaded = {
        "generator": _load(gen, args.checkpoints_folder_path, "generator",
                           args.allow_pickle, jax_table(
                               "generator", n_layers=args.gen_layers),
                           subdir="generator"),
        "fgd": _load(fgd, args.fgd_checkpoint, "FGD", args.allow_pickle,
                     jax_table("fgd")),
        "skeleton": _load(skeleton, args.skeleton_checkpoint,
                          "skeleton classifier", args.allow_pickle,
                          jax_table("skeleton", n_layers=3)),
        "cvae": _load(vae, args.cvae_checkpoint, "emotion CVAE",
                      args.allow_pickle, jax_table("cvae")),
    }
    for net in (gen, fgd, skeleton, vae):
        distributed.broadcast_module(net)
    dtype = torch.float32
    if args.precision == "bfloat16":
        dtype = torch.bfloat16
        prec.bf16_params_(gen)
        prec.cast_all_(vae, dtype)
    return EvalNets(gen, fgd, skeleton, vae, dtype, args.n_pre_poses, loaded)


@torch.no_grad()
def eval_batch(nets: EvalNets, spec, text, pose_seq, eid_label, noise=None,
               generator=None):
    """The per-batch device path: CVAE sample -> generator -> metric
    features. `noise` (B, 32) replaces the CVAE's z when given. Returns
    (poses fp32, skeleton logits, FGD features of the poses and of the
    target as (B * frames, 512), the mean absolute rotation error)."""
    pre_pose = pose_seq[:, : nets.n_pre_poses]
    spec, pre_pose, y = prec.cast_inputs(nets.dtype, spec, pre_pose,
                                         eid_label)
    sampled = nets.vae.sample(y, noise=noise, generator=generator)
    pred = nets.gen(spec, text.long(), pre_pose, sampled)[0].float()
    logits, _ = nets.skeleton(pred)
    _, pred_feat = nets.fgd(pred)
    _, target_feat = nets.fgd(pose_seq)
    rot_err = torch.mean(torch.abs(pose_seq - pred))
    return (pred, logits, pred_feat.reshape(-1, FEAT_DIM),
            target_feat.reshape(-1, FEAT_DIM), rot_err)


class _DeviceTimer:
    """Device time of each timed call: CUDA events on the card (read once,
    at the end), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.spans = []

    def __call__(self, fn, *args, **kwargs):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            self.spans.append((start, stop))
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.spans.append((time.perf_counter() - t0) * 1e3)
        return out

    def ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.spans]
        return list(self.spans)


def test_model(args, batches, n_words: int, noise=None):
    """Run the eval over `batches` (an iterable of numpy batch dicts,
    consumed lazily). `noise(i, k)`, for tests only, gives the CVAE's z
    (B, 32) of batch i, pass k (0 is the main pass) instead of the seeded
    draws. Returns the summary dict of the JAX CLI plus `timings`."""
    device = resolve_device(args.device)
    nets = build_models(args, n_words, device)
    rng = torch.Generator(device=device).manual_seed(args.seed + 1)

    def z_of(i, k):
        if noise is None:
            return None
        z = torch.as_tensor(np.asarray(noise(i, k)), dtype=torch.float32,
                            device=device)
        return mesh.rank_rows(z, z.shape[0] // mesh.world())

    if args.prefetch > 0:
        stream = Prefetcher(batches, device, buffer_size=args.prefetch,
                            host_keys=("audio",))
    else:
        stream = contextlib.nullcontext(
            place_batches(batches, device, host_keys=("audio",)))

    aligner = BeatAligner(0.3, 2)
    t_start = 0
    t_end = int(args.n_poses / args.motion_resampling_framerate)
    timer = _DeviceTimer(device)
    pred_feats, target_feats, extra_feats = [], [], []
    total_error_pose = 0.0
    total_rot = 0.0
    all_acc = 0.0
    bl_score = 0.0
    total_steps = 0
    n_beat_samples = 0
    beat_s = 0.0
    start = time.time()
    data_s = 0.0  # host time the loop waits for its next batch
    with stream as placed:
        batch_iter = iter(placed)
        for i in itertools.count():
            t0 = time.perf_counter()
            batch = next(batch_iter, None)
            data_s += time.perf_counter() - t0
            if batch is None:
                break
            total_steps += 1
            inputs = (batch["spectrogram"], batch["text"], batch["pose_seq"],
                      batch["eid_label"])
            pred, logits, pf, tf, rot_err = timer(
                eval_batch, nets, *inputs, noise=z_of(i, 0), generator=rng)
            # extra diversity passes: same inputs, fresh CVAE noise, pooled
            # into the diversity estimate only (FGD keeps one pass)
            for extra in range(max(args.num_diversity_passes, 1) - 1):
                pf2 = timer(eval_batch, nets, *inputs, noise=z_of(i, extra + 1),
                            generator=rng)[2]
                extra_feats.append(mesh.all_gather(pf2).cpu().numpy())
            pred_np = pred.cpu().numpy()
            target_np = batch["pose_seq"].cpu().numpy()
            labels = np.argmax(batch["eid_label"].cpu().numpy(), axis=1)
            # this rank's rows; the scalars are summed over the ranks at the
            # end, the features gathered in the global batch's row order
            all_acc += compute_acc(labels, logits.cpu().numpy())
            total_rot += float(rot_err)
            pred_feats.append(mesh.all_gather(pf).cpu().numpy())
            target_feats.append(mesh.all_gather(tf).cpu().numpy())
            total_error_pose += l2_distance_pose(pred_np, target_np)
            if not args.skip_beat:
                t0 = time.perf_counter()
                bl_score += aligner.score_batch(
                    batch["audio"], pred_np, t_start, t_end,
                    args.motion_resampling_framerate,
                    device_frontend=args.device_beat, device=device) \
                    * len(pred_np)
                beat_s += time.perf_counter() - t0
                n_beat_samples += len(pred_np)
    if total_steps == 0:
        raise ValueError("test_model: no batches")
    if mesh.active():
        # the per-rank means of equal row counts average to the global
        # batch's; beat scores and counts add
        sums = distributed.host_sum(torch.tensor(
            [all_acc, total_error_pose, total_rot, bl_score,
             n_beat_samples], dtype=torch.float64)).tolist()
        r = mesh.world()
        all_acc, total_error_pose, total_rot = (v / r for v in sums[:3])
        bl_score, n_beat_samples = sums[3], int(sums[4])
    wall_s = time.time() - start
    if not distributed.is_primary():
        batch_ms = timer.ms()
        return {"timings": {"device": str(device),
                            "eval_batch_calls": len(batch_ms),
                            "eval_batch_ms": batch_ms, "wall_s": wall_s,
                            "data_wait_s": data_s, "beat_s": beat_s}}

    t0 = time.perf_counter()
    pred_arr = np.concatenate(pred_feats)
    target_arr = np.concatenate(target_feats)
    fid_value = frechet_from_features(pred_arr, target_arr)
    div_arr = (np.concatenate(pred_feats + extra_feats)
               if extra_feats else pred_arr)
    div_score, div_interval = diversity_score(div_arr, seed=args.seed)
    frechet_s = time.perf_counter() - t0
    avg_bl = bl_score / n_beat_samples if n_beat_samples else 0.0
    total_error_pose /= total_steps
    total_rotation_error = total_rot / total_steps
    avg_acc = all_acc / total_steps
    wall_s = time.time() - start
    batch_ms = timer.ms()
    print("Div_score: {:.5f}, Div_interval: ({:.5f}, {:.5f})".format(
        div_score, div_interval[0], div_interval[1]))
    logging.info(
        ">>> Total_pose score: {:.5f},  Total_rotation score: {:.5f}, "
        "FGD_score: {:.5f}, Beat score: {:.5f}, Emotion_acc: {:.5f}, "
        "Div_score: {:.5f}, Div_interval: ({:.5f}, {:.5f})".format(
            total_error_pose, total_rotation_error * 57.2958, fid_value,
            avg_bl, avg_acc, div_score, div_interval[0], div_interval[1]))
    logging.info("eval wall time: %.1fs (%d batches)", wall_s, total_steps)
    return {
        "l2": total_error_pose,
        "mpjre_deg": total_rotation_error * 57.2958,
        "fgd": float(fid_value),
        "beat": avg_bl,
        "emotion_acc": avg_acc,
        "diversity": div_score,
        "diversity_interval": div_interval,
        "checkpoints": nets.loaded,
        "timings": {
            "device": str(device),
            "eval_batch_calls": len(batch_ms),
            "eval_batch_ms": batch_ms,
            "wall_s": wall_s,
            "data_wait_s": data_s,
            "beat_s": beat_s,
            "frechet_diversity_s": frechet_s,
        },
    }


def _rank_main(args, noise, exact_fp32):
    """One rank of a --num_devices run, with its launcher's TF32 setting."""
    if exact_fp32:
        fp32_exact_on_cuda()
    return main(args, noise)


def main(args=None, noise=None):
    """Run the eval. `noise` is test_model's test-only z hook."""
    argv = sys.argv[1:] if args is None else None
    if args is None:
        args = build_parser().parse_args()
    args = apply_preset(args, build_parser(), EVAL_FAST, argv=argv)
    device = resolve_device(args.device)
    ranks = mesh.plan(args, args.test_batch_size, device)
    if ranks > 1 and not distributed.is_initialized():
        return mesh.launch(_rank_main, ranks, args, noise,
                           not torch.backends.cudnn.allow_tf32,
                           device=device.type)[0]
    device = mesh.rank_device(device)
    args.device = str(device)
    set_logger(args.log_save_path,
               "test_emotion_gesture_diversity_iterative.log")
    logging.info("device: %s", torch.cuda.get_device_name(device)
                 if device.type == "cuda" else device)
    logging.info(pprint.pformat(vars(args)))

    if args.synthetic:
        test_dataset = SyntheticGestureDataset(
            n_samples=args.synthetic, seed=args.seed,
            class_overlap=args.class_overlap)
        n_words = N_WORDS_SYNTHETIC
    else:
        test_dataset = SpeechMotionDataset(
            args.test_data_path, n_poses=args.n_poses,
            subdivision_stride=args.subdivision_stride,
            pose_resampling_fps=args.motion_resampling_framerate,
            remove_word_timing=(args.input_context == "text"))
        lang_model = build_vocab(
            "words", [test_dataset.store],
            os.path.join(os.path.dirname(args.test_data_path.rstrip("/")),
                         "vocab_all.pkl"),
            args.wordembed_path, args.wordembed_dim)
        test_dataset.set_lang_model(lang_model)
        n_words = lang_model.n_words
    if len(test_dataset) < args.test_batch_size:
        raise SystemExit(
            f"test set smaller than --test_batch_size={args.test_batch_size}")
    # raw audio is only read by the beat metric: with --skip_beat it is
    # never collated
    eval_fields = ("spectrogram", "text", "pose_seq", "eid_label")
    if not args.skip_beat:
        eval_fields = ("audio",) + eval_fields
    batches = test_dataset.batches(args.test_batch_size, shuffle=False,
                                   fields=eval_fields,
                                   rows=batch_rows(args.test_batch_size))
    return test_model(args, batches, n_words, noise=noise)


def cli() -> None:
    """Command-line entry point (main's return value is not an exit
    status). The CLI owns this process, so fp32 runs on the card with TF32
    off."""
    argv = sys.argv[1:]
    args = apply_preset(build_parser().parse_args(argv), build_parser(),
                        EVAL_FAST, argv=argv)
    if args.precision == "float32" and \
            resolve_device(args.device).type == "cuda":
        fp32_exact_on_cuda()
    main(args)


if __name__ == "__main__":
    cli()
