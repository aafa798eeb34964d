"""The port's K-fold classifier CLI (emotiongestures_torch/cli/
train_audio_classifier_K_fold.py) on the CPU: fp32 and --preset fast,
--resume from its checkpoint and kfold_progress.json, and the refusals of
what is not ported.

The synthetic set's spectrograms are (128, 124), which would build the
full EmotionNet (fc0 65,536 x 4096); the CLI module's dataset class is
swapped for an in-memory stand-in of (32, 32) spectrograms, where fc0 is
4096 x 4096. The full shape runs on the card (chip_smoke.py phase 8). A
checkpoint is ~380 MB; each test removes its run directory when it ends.
"""
import json
import shutil

import numpy as np
import pytest
from torch_port_train_common import TinySpectrograms
from torch_port_train_common import one_torch_thread  # noqa: F401

from emotiongestures_torch.cli import train_audio_classifier_K_fold as cli
from emotiongestures_torch.utils.checkpoint import latest_step

# 40 samples, 10 folds: 36 train -> 4 steps of 8 per epoch; a test set of
# max(8, 40 // 4) = 10 samples -> one batch of 8
FLAGS = ["--device", "cpu", "--synthetic", "40", "--batch_size", "8",
         "--max_folds", "1"]


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "SyntheticGestureDataset", TinySpectrograms)
    path = tmp_path / "run"
    yield path
    shutil.rmtree(path, ignore_errors=True)


def _main(run_dir, *flags):
    return cli.main(cli.build_parser().parse_args(
        FLAGS + ["--model_save_path", str(run_dir), *flags]))


@pytest.mark.parametrize("preset,dtype", [("parity", "float32"),
                                          ("fast", "bfloat16")],
                         ids=["parity", "fast"])
def test_main_trains_one_fold(run_dir, preset, dtype, monkeypatch):
    seen = []
    step = cli.classifier.train_step

    def spy(state, spec, labels, alpha, gamma=2.0,
            compute_dtype="float32"):
        seen.append(compute_dtype)
        return step(state, spec, labels, alpha, gamma, compute_dtype)

    monkeypatch.setattr(cli.classifier, "train_step", spy)
    results = _main(run_dir, "--total_epoch", "1", "--preset", preset)
    assert [r["fold"] for r in results] == [0]
    r = results[0]
    assert r["state"].step == 4 and len(r["step_ms"]) == 4
    assert seen == [dtype] * 4
    assert 0.0 <= r["test_acc"] <= 100.0 and r["confusion"].sum() == 8
    assert latest_step(run_dir) is None  # eval_every 100: no checkpoint
    log = (run_dir / "train_audio_classifier_K_fold.log").read_text()
    assert (run_dir / "confusion_fold1.png").exists() or \
        "confusion-matrix plot failed" in log


def test_resume_continues_the_fold(run_dir):
    """A checkpoint every 4 steps; the second run with --resume and one
    more epoch continues fold 0 from step 4 to step 8, keeping only the
    newest checkpoint."""
    first = _main(run_dir, "--total_epoch", "1", "--eval_every", "4")
    assert first[0]["state"].step == 4 and latest_step(run_dir) == 4
    progress = json.loads((run_dir / "kfold_progress.json").read_text())
    assert progress == {"fold": 0, "epoch": 0, "iter": 4}
    resumed = _main(run_dir, "--total_epoch", "2", "--eval_every", "4",
                    "--resume")
    r = resumed[0]
    assert r["fold"] == 0 and r["state"].step == 8
    assert len(r["step_ms"]) == 4
    assert np.isfinite(r["test_acc"])
    assert sorted(p.name for p in run_dir.glob("checkpoint_iteration*")) \
        == ["checkpoint_iteration8.pt"]
    log = (run_dir / "train_audio_classifier_K_fold.log").read_text()
    assert "resuming fold 1 from iter 4" in log


@pytest.mark.parametrize("flags,error,match", [
    (["--synthetic", "0", "--train_data_path", "missing/train"],
     FileNotFoundError, "no GestureStore"),
    (["--num_devices", "2"], NotImplementedError, "item 6"),
], ids=["real-data", "devices"])
def test_refusals(run_dir, flags, error, match):
    with pytest.raises(error, match=match):
        _main(run_dir, *flags)
