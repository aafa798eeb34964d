"""Skeleton-animation rendering (port of emotiongestures_tpu/utils/
render.py; the reference's utils/train_utils_expressive.py:63-150): a
matplotlib 3-D side-by-side human/generated animation, saved as an mp4 by
ffmpeg and merged with the audio when ffmpeg is on the path, else as an
animated gif through pillow. matplotlib is an optional dependency, imported
when a video is made; `require_matplotlib` checks for it up front. Returns
the paths it wrote.
"""
from __future__ import annotations

import logging
import os
import shutil
import subprocess
import time
from textwrap import wrap

import numpy as np

from ..ops.pose import DIR_VEC_PAIRS, convert_dir_vec_to_pose


def require_matplotlib() -> None:
    """Raise a RuntimeError naming matplotlib when it cannot be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        raise RuntimeError(
            "rendering needs matplotlib, which is not importable here: "
            "install it, or run without --render") from exc


def create_video_and_save(save_path, epoch, prefix, iter_idx, target,
                          output, mean_data, title, audio=None,
                          aux_str=None, clipping_to_shortest_stream=False,
                          delete_audio_file=True, fps: int = 15,
                          pairs=DIR_VEC_PAIRS):
    """target/output: (T, n_pairs*3) mean-centred dir-vec sequences."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    logging.info("rendering a video...")
    start = time.time()
    os.makedirs(save_path, exist_ok=True)

    fig = plt.figure(figsize=(8, 4))
    axes = [fig.add_subplot(1, 2, 1, projection="3d"),
            fig.add_subplot(1, 2, 2, projection="3d")]
    for ax in axes:
        ax.view_init(elev=20, azim=-60)
    fig_title = title + ("\n" + aux_str if aux_str else "")
    fig.suptitle("\n".join(wrap(fig_title, 75)), fontsize="medium")

    mean_data = np.asarray(mean_data).flatten()
    output_poses = convert_dir_vec_to_pose(np.asarray(output) + mean_data,
                                           pairs)
    target_poses = None
    if target is not None:
        target_poses = convert_dir_vec_to_pose(
            np.asarray(target) + mean_data, pairs)

    def animate(i):
        for k, name in enumerate(["human", "generated"]):
            if name == "human" and target_poses is not None \
                    and i < len(target_poses):
                pose = target_poses[i]
            elif name == "generated" and i < len(output_poses):
                pose = output_poses[i]
            else:
                pose = None
            if pose is not None:
                axes[k].clear()
                for parent, child, _ in pairs:
                    axes[k].plot(
                        [pose[parent, 0], pose[child, 0]],
                        [pose[parent, 2], pose[child, 2]],
                        [pose[parent, 1], pose[child, 1]],
                        zdir="z", linewidth=1.5)
                axes[k].set_xlim3d(-0.5, 0.5)
                axes[k].set_ylim3d(0.5, -0.5)
                axes[k].set_zlim3d(0.5, -0.5)
                axes[k].set_title(
                    f"{name} ({i + 1}/{len(output_poses)})")

    num_frames = len(output_poses) if target_poses is None else max(
        len(target_poses), len(output_poses))
    ani = animation.FuncAnimation(fig, animate, interval=30,
                                  frames=num_frames, repeat=False)

    audio_path = None
    if audio is not None:
        audio_path = f"{save_path}/{prefix}_{epoch:03d}_{iter_idx}.wav"
        _write_wav(audio_path, np.asarray(audio, np.float32))

    video_path = f"{save_path}/temp_{prefix}_{epoch:03d}_{iter_idx}.mp4"
    have_ffmpeg = shutil.which("ffmpeg") is not None
    if have_ffmpeg:
        ani.save(video_path, fps=fps, dpi=80)
    else:  # fall back to an animated gif (pillow writer ships w/ mpl)
        video_path = video_path.replace(".mp4", ".gif")
        ani.save(video_path, writer="pillow", fps=fps, dpi=60)
    del ani
    plt.close(fig)

    merged = video_path
    if audio is not None and have_ffmpeg:
        merged = f"{save_path}/{prefix}_{epoch:03d}_{iter_idx}.mp4"
        cmd = ["ffmpeg", "-loglevel", "panic", "-y", "-i", video_path,
               "-i", audio_path, "-strict", "-2", merged]
        if clipping_to_shortest_stream:
            cmd.insert(len(cmd) - 1, "-shortest")
        subprocess.call(cmd)
        if delete_audio_file:
            os.remove(audio_path)
        os.remove(video_path)

    logging.info("done, took %.1f seconds", time.time() - start)
    return merged, output_poses, target_poses


def _write_wav(path, audio, sr: int = 16000):
    """Minimal 16-bit PCM wav writer (soundfile not required)."""
    import wave

    data = np.clip(audio, -1.0, 1.0)
    pcm = (data * 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
