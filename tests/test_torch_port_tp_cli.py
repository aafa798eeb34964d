"""The port's CLIs with --num_devices 2 --model_parallel 2 on the CPU (a
1 x 2 grid of gloo ranks), against the same CLI in one process: the GAN
trainer's losses and checkpoints within tests/test_parallel.py's criteria,
its checkpoints in the one-process layout, `--resume` across layouts (a
grid run's checkpoint continued in one process and a one-process run's on
the grid, both ending where the other does), and the eval CLI's metrics
with fused attention (the partial-heads form's plain version) within
test_torch_port_eval.py's tolerances. The ranks' torch runs on one thread
each; each test removes its run directories when it ends.
"""
import shutil

import numpy as np
import pytest
import torch

from emotiongestures_torch.cli import (
    test_emotion_gesture_diversity_iterative as eval_cli,
)
from emotiongestures_torch.cli import train_emotion_gesture as train_cli
from emotiongestures_torch.models.generator import GestureTransformer
from emotiongestures_torch.utils.checkpoint import latest_step

SMALL = ["--device", "cpu", "--d_model", "64", "--latent_dim", "128",
         "--gen_layers", "1"]
GAN = SMALL + ["--n_frames", "20", "--pose_dim", "12", "--save_every",
               "1000", "--prefetch", "0", "--synthetic", "8",
               "--batch_size", "8", "--total_epoch", "1"]
GRID = ["--num_devices", "2", "--model_parallel", "2"]
GAN_KEYS = ("g_loss", "g_rec", "g_emo", "g_con", "g_adv", "d_loss")


@pytest.fixture(autouse=True)
def one_thread_and_cleanup(monkeypatch, tmp_path):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _gan(run_dir, *flags):
    return train_cli.main(train_cli.build_parser().parse_args(
        GAN + ["--model_save_path", str(run_dir), *flags]))[2]


def _checkpoint(run_dir, net="generator"):
    step = latest_step(run_dir / net)
    return step, torch.load(run_dir / net / f"checkpoint_iteration{step}.pt",
                            weights_only=True)


def _state_failures(one, got, steps, lr=2e-4):
    """test_parallel.py's state criterion: every entry within 5e-3, at
    most 0.1% of elements beyond steps * 2 * lr."""
    bad, n_out, n_tot = [], 0, 0
    for k, want in one.items():
        diff = (got[k].double() - want.double()).abs()
        if diff.numel() and float(diff.max()) >= 5e-3:
            bad.append(f"{k}: {float(diff.max()):.3g}")
        n_out += int((diff > steps * 2 * lr).sum())
        n_tot += diff.numel()
    if n_out > max(1, n_tot // 1000):
        bad.append(f"{n_out} of {n_tot} beyond")
    return bad


def test_gan_trainer_on_a_grid_and_resume_across_layouts(tmp_path):
    """A step on a 1 x 2 grid and in one process from the same seed:
    losses within rtol 2e-4, the checkpoints whole (they load strictly
    into a one-process generator) and within the state criterion; then
    each resumes in the other layout for a step more, and the two step-2
    checkpoints agree."""
    one, grid = tmp_path / "one", tmp_path / "grid"
    s_one = _gan(one)
    s_grid = _gan(grid, *GRID)
    assert s_one["steps"] == s_grid["steps"] == 1 and s_grid["ranks"] == 2
    for k in GAN_KEYS:
        np.testing.assert_allclose(s_grid["metrics"][k], s_one["metrics"][k],
                                   rtol=2e-4, atol=1e-5, err_msg=k)
    log = (grid / "train_emotion_gesture.log").read_text()
    assert "data x model mesh: {'data': 1, 'model': 2}" in log
    for net in ("generator", "discriminator"):
        (step_a, a), (step_b, b) = _checkpoint(one, net), _checkpoint(grid,
                                                                     net)
        assert step_a == step_b == 1
        assert {k: v.shape for k, v in a["model"].items()} == \
            {k: v.shape for k, v in b["model"].items()}
        assert _state_failures(a["model"], b["model"], 1) == []
        for i, st in a["optimizer"]["state"].items():
            for k, v in st.items():
                assert b["optimizer"]["state"][i][k].shape == v.shape
    gen = GestureTransformer(n_words=64, frames=20, pose_dim=12, d_model=64,
                             d_inner=128, n_layers=1, device="cpu")
    gen.load_state_dict(_checkpoint(grid)[1]["model"], strict=True)

    # each run's directory copied (not its writer's lock), then resumed in
    # the other layout
    a_dir, b_dir = tmp_path / "grid_then_one", tmp_path / "one_then_grid"
    for src, dst in ((grid, a_dir), (one, b_dir)):
        shutil.copytree(src, dst,
                        ignore=shutil.ignore_patterns(".egtp_writer.lock"))
    s_one = _gan(a_dir, "--resume")
    s_grid = _gan(b_dir, *GRID, "--resume")
    assert s_one["steps"] == s_grid["steps"] == 2
    for net in ("generator", "discriminator"):
        (step_a, a), (step_b, b) = _checkpoint(a_dir, net), _checkpoint(
            b_dir, net)
        assert step_a == step_b == 2
        assert _state_failures(a["model"], b["model"], 2) == []


def test_eval_cli_on_a_grid_matches_one_process(tmp_path):
    """2 batches of 8 with fused attention, beat alignment on: the grid's
    metrics against one process's (l2, mpjre, diversity rtol 1e-5; FGD
    rtol 1e-4; Emotion-Acc equal; beat atol 1e-3)."""
    def run(*extra):
        return eval_cli.main(eval_cli.build_parser().parse_args(
            SMALL + ["--synthetic", "16", "--test_batch_size", "8",
                     "--fused_attention", "--log_save_path", str(tmp_path),
                     *extra]))

    one = run()
    grid = run(*GRID)
    for key in ("l2", "mpjre_deg", "diversity"):
        np.testing.assert_allclose(grid[key], one[key], rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(grid["fgd"], one["fgd"], rtol=1e-4)
    np.testing.assert_allclose(grid["beat"], one["beat"], atol=1e-3)
    assert grid["emotion_acc"] == one["emotion_acc"]
    assert grid["timings"]["eval_batch_calls"] == 2
    log = (tmp_path / "test_emotion_gesture_diversity_iterative.log"
           ).read_text()
    assert "serving mesh: {'data': 1, 'model': 2}" in log

