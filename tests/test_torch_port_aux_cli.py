"""The port's auxiliary trainer CLI (emotiongestures_torch/cli/
train_auxiliary.py) on the CPU, mirroring the JAX package's tests of its
own (tests/test_cli_mains.py: main and --resume, the plateau reseed), with
the refusals of what is not ported, and the eval CLI reading the
checkpoint directories the port's trainers write.

Small flags: 16 synthetic samples in batches of 8 (2 steps an epoch); the
skeleton classifier at its fixed d_model 512 with d_inner 64 over 12
frames (its flatten head is frames * 512 -> 2048); the CVAE's frozen
generator at d_model 64, d_inner 128, one layer. Each test removes its run
directory when it ends.
"""
import shutil

import numpy as np
import pytest
import torch
from torch_port_train_common import one_torch_thread  # noqa: F401

from emotiongestures_torch.cli import (
    test_emotion_gesture_diversity_iterative as eval_cli,
)
from emotiongestures_torch.cli import train_auxiliary as cli
from emotiongestures_torch.data.synthetic import SyntheticGestureDataset
from emotiongestures_torch.train import gan
from emotiongestures_torch.utils.checkpoint import (
    latest_step,
    save_checkpoint,
)

BASE = ["--device", "cpu", "--synthetic", "16", "--batch_size", "8",
        "--total_epoch", "1", "--save_every", "1000"]
SKELETON = ["--model", "skeleton", "--n_poses", "12", "--latent_dim", "64"]
GEN = ["--d_model", "64", "--latent_dim", "128", "--gen_layers", "1"]


@pytest.fixture
def run_dir(tmp_path):
    path = tmp_path / "run"
    yield path
    shutil.rmtree(path, ignore_errors=True)


def _main(run_dir, *flags):
    return cli.main(cli.build_parser().parse_args(
        BASE + ["--model_save_path", str(run_dir), *flags]))


def test_fgd_main_and_resume(run_dir):
    state, summary = _main(run_dir, "--model", "fgd")
    assert state.step == summary["steps"] == 2
    assert len(summary["step_ms"]) == 2
    assert np.isfinite(summary["metrics"]["loss"])
    assert latest_step(run_dir / "fgd") == 2
    state, summary = _main(run_dir, "--model", "fgd", "--resume")
    assert state.step == summary["steps"] == 4
    assert state.optimizer.state[next(state.module.parameters())][
        "step"] == 4
    assert latest_step(run_dir / "fgd") == 4


def test_skeleton_plateau_reseed(run_dir):
    """An unreachable target: the trainer reseeds after one step, drops the
    plateaued attempt's checkpoints and finishes on the fresh state."""
    state, summary = _main(run_dir, *SKELETON, "--save_every", "1",
                           "--plateau_patience", "1", "--plateau_acc",
                           "101.0", "--max_reseeds", "1")
    log_text = (run_dir / "train_skeleton.log").read_text()
    assert "plateau" in log_text and "reseeding (attempt 1/1)" in log_text
    assert summary["steps"] == 2 and state.step == 1
    assert set(summary["metrics"]) == {"loss", "acc"}
    for p in state.module.parameters():
        assert torch.isfinite(p).all()
    assert latest_step(run_dir / "skeleton") == state.step


def test_cvae_features_from_a_generator_checkpoint(run_dir):
    """--generator_checkpoint names a GAN trainer's --model_save_path: the
    generator loads from its generator/ directory, runs in eval mode
    without gradients (the same features twice, its weights untouched) and
    the CVAE trains on its emotion features."""
    cfg = gan.GANConfig(d_model=64, d_inner=128, n_layers=1)
    gen_state, _ = gan.create_states(cfg, seed=3, device="cpu")
    save_checkpoint(gen_state, run_dir / "gan" / "generator")
    flags = ["--model", "cvae", *GEN, "--generator_checkpoint",
             str(run_dir / "gan")]
    args = cli.build_parser().parse_args(
        BASE + ["--model_save_path", str(run_dir), *flags])
    features = cli._emotion_features(args, torch.device("cpu"))
    batch = next(SyntheticGestureDataset(n_samples=4, seed=1).batches(
        4, shuffle=False, fields=cli.FIELDS["cvae"]))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, again = features(batch), features(batch)
    with torch.no_grad():
        want = gen_state.module.eval()(
            batch["spectrogram"], batch["text"].long(),
            batch["pose_seq"][:, :10])[1]
    assert got.shape == (4, 60, 64) and not got.requires_grad
    assert torch.equal(got, again) and torch.equal(got, want)
    state, summary = _main(run_dir, *flags)
    assert state.step == 2
    assert all(np.isfinite(v) for v in summary["metrics"].values())
    assert set(summary["metrics"]) == {"loss", "recon", "kl"}
    assert "loaded generator checkpoint" in (
        run_dir / "train_cvae.log").read_text()


@pytest.mark.parametrize("flags,error,match", [
    (["--model", "fgd", "--synthetic", "0", "--train_data_path",
      "missing/train"], FileNotFoundError, "no GestureStore"),
    (["--model", "fgd", "--num_devices", "2"], NotImplementedError,
     "item 6"),
    (["--model", "fgd", "--coordinator_address", "localhost:1234"],
     NotImplementedError, "item 6"),
    (["--model", "fgd", "--process_id", "0"], NotImplementedError, "item 6"),
    (["--model", "cvae", "--cvae_version", "2"], NotImplementedError,
     "item 7"),
    (SKELETON + ["--grad_clip", "-0.5"], ValueError, "grad_clip"),
], ids=["real-data", "devices", "multi-host", "process-id", "cvae-v2",
        "negative-clip"])
def test_refusals(run_dir, flags, error, match):
    with pytest.raises(error, match=match):
        _main(run_dir, *flags)


def test_eval_cli_reads_the_trainers_checkpoints(run_dir):
    """Train the FGD autoencoder two steps, then point the eval CLI at its
    directory, and at a GAN trainer's --model_save_path for the generator:
    the eval nets hold the trained weights."""
    state, _ = _main(run_dir, "--model", "fgd")
    cfg = gan.GANConfig(d_model=64, d_inner=128, n_layers=1)
    gen_state, _ = gan.create_states(cfg, seed=5, device="cpu")
    save_checkpoint(gen_state, run_dir / "gan" / "generator")
    args = eval_cli.build_parser().parse_args([
        "--device", "cpu", *GEN, "--fgd_checkpoint", str(run_dir / "fgd"),
        "--checkpoints_folder_path", str(run_dir / "gan")])
    nets = eval_cli.build_models(args, 64, torch.device("cpu"))
    assert nets.loaded["fgd"].endswith("fgd/checkpoint_iteration2.pt")
    assert nets.loaded["generator"].endswith(
        "gan/generator/checkpoint_iteration0.pt")
    assert nets.loaded["skeleton"] is None and nets.loaded["cvae"] is None
    for got, want in ((nets.fgd, state.module), (nets.gen,
                                                 gen_state.module)):
        trained = want.state_dict()
        for k, v in got.state_dict().items():
            assert torch.equal(v, trained[k]), k
