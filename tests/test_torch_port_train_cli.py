"""The port's trainer CLI (emotiongestures_torch/cli/train_emotion_gesture)
on the CPU, mirroring the JAX package's own tests
(tests/test_cli_mains.py: main and --resume, --profile_dir, SIGTERM): it
trains, checkpoints, resumes from the saved step and exits 0 on SIGTERM.

The flags keep it small: 4 samples in batches of 2, 20 frames (the least
the prior encoder's 10 seed frames and 10-frame memory chunk allow),
pose_dim 12, d_model 16. A checkpoint pair is still ~60 MB, held by the
SE-ResNet's fixed widths and the discriminator's 64 * 19 -> 2048 layer;
each test removes its run directory when it ends.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from emotiongestures_torch.cli import train_emotion_gesture as cli
from emotiongestures_torch.utils.checkpoint import latest_step
from torch_port_train_common import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--synthetic", "4", "--batch_size", "2",
         "--n_frames", "20", "--pose_dim", "12", "--d_model", "16",
         "--latent_dim", "32", "--gen_layers", "1", "--save_every", "1000"]


@pytest.fixture
def run_dir(tmp_path):
    path = tmp_path / "run"
    yield path
    shutil.rmtree(path, ignore_errors=True)


def _main(run_dir, *extra):
    args = cli.build_parser().parse_args(
        SMALL + ["--model_save_path", str(run_dir), *extra])
    return cli.main(args)


def test_main_and_resume_continue_the_step_counter(run_dir):
    gen, disc, summary = _main(run_dir, "--total_epoch", "1")
    assert gen.step == disc.step == summary["steps"] == 2
    assert len(summary["step_ms"]) == 2
    assert all(np.isfinite(v) for v in summary["metrics"].values())
    for p in gen.module.parameters():
        assert torch.isfinite(p).all()
    assert latest_step(run_dir / "generator") == 2
    assert latest_step(run_dir / "discriminator") == 2
    gen, disc, _ = _main(run_dir, "--total_epoch", "1", "--resume")
    assert gen.step == disc.step == 4
    assert gen.optimizer.state[next(gen.module.parameters())]["step"] == 4


def test_warmup_follows_the_global_epoch_after_resume(run_dir):
    """--pose_dis_warm_epoch 1: the first epoch trains G alone; a resumed
    run is in global epoch 1, so D trains from its first step."""
    gen, disc, summary = _main(run_dir, "--total_epoch", "1",
                               "--pose_dis_warm_epoch", "1")
    assert (gen.step, disc.step) == (2, 0)
    assert summary["metrics"]["d_loss"] == summary["metrics"]["g_adv"] == 0
    gen, disc, summary = _main(run_dir, "--total_epoch", "1",
                               "--pose_dis_warm_epoch", "1", "--resume")
    assert (gen.step, disc.step) == (4, 2)
    assert summary["metrics"]["d_loss"] > 0


def test_fast_preset_cast_inputs_and_data_echo(run_dir):
    """--preset fast (bf16 compute, g_first) with the host bf16 cast and
    two echoes of each batch: 2 batches x 2 echoes."""
    gen, disc, summary = _main(run_dir, "--total_epoch", "1", "--preset",
                               "fast", "--cast_inputs", "true",
                               "--data_echo", "2")
    assert gen.step == disc.step == 4
    assert all(np.isfinite(v) for v in summary["metrics"].values())
    for p in gen.module.parameters():
        assert p.dtype == torch.float32


def test_profile_dir_writes_a_trace(run_dir, tmp_path):
    """The window opens at the fourth step: 2 epochs x 2 steps reach it."""
    trace_dir = tmp_path / "trace"
    gen, _, _ = _main(run_dir, "--total_epoch", "2", "--profile_dir",
                      str(trace_dir), "--profile_steps", "1")
    assert gen.step == 4
    events = json.loads((trace_dir / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert any("conv" in str(n) for n in names)


@pytest.mark.parametrize("extra,match", [
    (["--synthetic", "0"], "item 4"),
    (["--num_devices", "2"], "item 6"),
    (["--model_parallel", "2"], "item 6"),
    (["--coordinator_address", "localhost:1234"], "item 6"),
    (["--variant", "base"], "item 7"),
], ids=["real-data", "devices", "model-parallel", "multi-host", "variant"])
def test_unported_paths_are_refused(run_dir, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        _main(run_dir, *extra)


def test_cast_inputs_needs_bf16(run_dir):
    with pytest.raises(SystemExit, match="cast_inputs"):
        _main(run_dir, "--cast_inputs", "true")


def test_sigterm_checkpoints_and_resumes(run_dir):
    """SIGTERM mid-run: the trainer checkpoints at a step boundary and
    exits 0; a --resume run continues from that step."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # as one_torch_thread does in-process
    cmd = [sys.executable, "-m", "emotiongestures_torch.cli."
           "train_emotion_gesture", *SMALL, "--model_save_path",
           str(run_dir)]
    proc = subprocess.Popen(cmd + ["--total_epoch", "10000"], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        # the first metrics line lands at step 10
        metrics = run_dir / "metrics.jsonl"
        deadline = time.time() + 300
        while not (metrics.exists() and metrics.stat().st_size > 0):
            assert proc.poll() is None, proc.stderr.read()[-3000:]
            assert time.time() < deadline, "the trainer never reached step 10"
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert "clean shutdown on signal" in err
    step = latest_step(run_dir / "generator")
    assert step is not None and step >= 10
    assert latest_step(run_dir / "discriminator") == step
    resumed = subprocess.run(cmd + ["--total_epoch", "1", "--resume"],
                             cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=300)
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert f"resumed from step {step}" in resumed.stderr
    assert latest_step(run_dir / "generator") == step + 2
