"""End-to-end inference demo: waveform -> log-mel frontend -> emotion-
conditioned diverse gesture generation (port of emotiongestures_tpu/cli/demo.py).

  python -m emotiongestures_torch.cli.demo --seconds 4 --emotion happiness \
      --num_samples 3 --frontend pallas --out ./demo_out

Runs on the CUDA card unless `--device cpu` is given. `--frontend pallas`
takes the hand-written CUDA mel kernel (the name of the JAX demo's Pallas
frontend), `xla` the plain PyTorch mel. Each diverse sample is its own
batch-one forward, as the JAX demo's vmap over keys makes it: TMMemory mixes
the rows of a batch, so stacking the samples would change them. Checkpoints
are state_dict files in the reference PyTorch layout (`torch.save`), the
port's trainers' checkpoint directories, or the JAX package's orbax
checkpoints (a `checkpoint_iteration<N>` directory or the directory holding
them), read by `utils.weights.load_reference_checkpoint`.

`--render` draws the first sample's first 9 direction vectors as a stick
figure (utils/render.py): an mp4 with the audio when ffmpeg is on the path,
else a gif. It needs matplotlib; without it the demo stops before it builds
a model, where the JAX demo fails only after generating.

Run from the command line with `--precision float32` on the card, the demo
turns TF32 off for its process (`core.device.fp32_exact_on_cuda`) so that the
convolutions compute in full fp32. `main()` called from other code leaves
that process-wide switch to its caller.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from ..core import precision as prec
from ..core.device import fp32_exact_on_cuda, resolve_device
from ..data.constants import EMOTION_LABELS
from ..models.cvae import EmotionCVAEv3
from ..models.generator import GestureTransformer
from ..ops.fused_mel import extract_melspectrogram
from ..ops.mel import calc_spectrogram_length_from_motion_length
from ..utils.weights import jax_table, load_reference_checkpoint


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav", type=str, default=None,
                        help="input wav (16 kHz mono); synthetic tone "
                             "when omitted")
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--emotion", type=str, default="happiness",
                        choices=EMOTION_LABELS)
    parser.add_argument("--num_samples", type=int, default=3,
                        help="diverse samples per clip, one batch-one "
                             "forward each")
    parser.add_argument("--checkpoints_folder_path", type=str, default=None,
                        help="generator state_dict file (reference layout)")
    parser.add_argument("--cvae_checkpoint", type=str, default=None,
                        help="EmotionCVAEv3 state_dict file")
    parser.add_argument("--pose_dim", type=int, default=282)
    parser.add_argument("--n_frames", type=int, default=60)
    parser.add_argument("--n_pre_poses", type=int, default=10)
    parser.add_argument("--n_words", type=int, default=64)
    parser.add_argument("--frontend", type=str, default="xla",
                        choices=["xla", "pallas"],
                        help="pallas: the CUDA mel kernel; xla: plain torch")
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--out", type=str, default="./demo_out")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--precision", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def load_wave(args) -> np.ndarray:
    n = int(args.seconds * 16000)
    if args.wav:
        import wave as wavmod

        with wavmod.open(args.wav, "rb") as f:
            assert f.getframerate() == 16000, "expected 16 kHz wav"
            raw = f.readframes(f.getnframes())
            data = np.frombuffer(raw, dtype=np.int16).astype(np.float32)
            data /= 32768.0
            if f.getnchannels() > 1:
                data = data.reshape(-1, f.getnchannels()).mean(axis=1)
        return data[:n] if len(data) >= n else np.pad(
            data, (0, n - len(data)), mode="symmetric")
    t = np.arange(n) / 16000.0
    beat = 0.5 + 0.5 * np.square(np.sin(np.pi * 2.0 * t))
    return (0.4 * beat * np.sin(2 * np.pi * 220 * t)).astype(np.float32)


def main(args=None, noise=None):
    """Run the demo. `noise` (num_samples, 32), when given, stands in for
    the CVAE prior's z of each sample (tests inject it)."""
    if args is None:
        args = build_parser().parse_args()
    if args.render:
        from ..utils.render import require_matplotlib

        require_matplotlib()
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    wave = load_wave(args)
    spec_len = calc_spectrogram_length_from_motion_length(args.n_frames, 15)
    spec = extract_melspectrogram(wave, use_kernel=args.frontend == "pallas",
                                  device=device)
    spec = spec.float()[None, :, :spec_len]

    torch.manual_seed(args.seed)
    gen = GestureTransformer(n_words=args.n_words, frames=args.n_frames,
                             pose_dim=args.pose_dim,
                             prior_frames=args.n_pre_poses,
                             spec_len=spec_len, device=device)
    vae = EmotionCVAEv3(device=device)
    if args.checkpoints_folder_path:
        load_reference_checkpoint(gen, args.checkpoints_folder_path,
                                  table=jax_table("generator", n_layers=len(
                                      gen.encoder.layer_stack)))
        logging.info("loaded generator checkpoint")
    if args.cvae_checkpoint:
        load_reference_checkpoint(vae, args.cvae_checkpoint,
                                  table=jax_table("cvae"))
        logging.info("loaded CVAE checkpoint")
    if not (args.checkpoints_folder_path or args.cvae_checkpoint):
        logging.warning("no checkpoints given — random weights (pipeline "
                        "demo only)")

    text = torch.zeros((1, args.n_frames), dtype=torch.long, device=device)
    prior = torch.zeros((1, args.n_pre_poses, args.pose_dim), device=device)
    y = torch.zeros((1, len(EMOTION_LABELS)), device=device)
    y[0, EMOTION_LABELS.index(args.emotion)] = 1.0
    if args.precision == "bfloat16":
        prec.bf16_params_(gen)
        prec.cast_all_(vae, torch.bfloat16)
        spec, prior, y = prec.cast_inputs(torch.bfloat16, spec, prior, y)

    rng = torch.Generator(device=device).manual_seed(args.seed + 3)
    t0 = time.time()
    samples = []
    with torch.no_grad():
        for i in range(args.num_samples):
            z = None if noise is None else torch.as_tensor(
                noise[i: i + 1], dtype=torch.float32, device=device)
            sampled = vae.sample(y, noise=z, generator=rng)
            out = gen(spec, text, prior, sampled)[0]
            samples.append(out[0].float())
    poses = torch.stack(samples).cpu().numpy()
    dt = time.time() - t0
    logging.info("generated %d diverse samples of (%d, %d) in %.2fs "
                 "(emotion=%s)", args.num_samples, args.n_frames,
                 args.pose_dim, dt, args.emotion)

    out_npz = os.path.join(args.out, "gestures.npz")
    np.savez(out_npz, poses=poses, wave=wave, emotion=args.emotion)
    pairwise = float(np.mean([
        np.linalg.norm(poses[i] - poses[j])
        for i in range(len(poses)) for j in range(i + 1, len(poses))
    ])) if len(poses) > 1 else 0.0
    summary = {"out": out_npz, "samples": int(args.num_samples),
               "frames": int(args.n_frames), "pose_dim": int(args.pose_dim),
               "pairwise_sample_distance": round(pairwise, 4),
               "gen_seconds": round(dt, 3)}
    print(json.dumps(summary))

    if args.render:
        from ..utils.render import create_video_and_save

        # the first 9 direction vectors as a 10-joint stick figure
        summary["video"] = create_video_and_save(
            args.out, 0, "demo", 0, None, poses[0][:, :27], np.zeros(27),
            f"demo ({args.emotion})", audio=wave)[0]
    return summary


def cli() -> None:
    """Console-script entry point (main's return value is not an exit
    status). The demo owns this process, so fp32 runs on the card with
    TF32 off."""
    args = build_parser().parse_args()
    if args.precision == "float32" and resolve_device(args.device).type \
            == "cuda":
        fp32_exact_on_cuda()
    main(args)


if __name__ == "__main__":
    cli()
