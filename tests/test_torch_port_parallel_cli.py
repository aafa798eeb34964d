"""The port's CLIs with two data-parallel ranks on the CPU (gloo):
`--num_devices 2 --device cpu` for the GAN trainer, the auxiliary trainer
(--model fgd), the K-fold CLI and the eval CLI, and the GAN trainer as two
processes joined by --coordinator_address / --num_processes / --process_id.
Each against the same CLI in one process: the trainers' step-0 losses
within rtol 2e-4 (tests/test_parallel.py), the K-fold fold's test accuracy
and confusion matrix equal, the eval's metrics within
test_torch_port_eval.py's tolerances. Only rank 0 writes the log and the
checkpoints (a second writer would meet the checkpoint directory's lock
and fail the run).

The ranks' torch runs on one thread each (OMP_NUM_THREADS, inherited by
the spawned processes): the suite's workers share the cores. Where a test
starts ranks or processes that need nothing from its one-process run, they
run while that run computes. Each test
removes its run directories when it ends (the K-fold checkpoint of the
16 x 16 EmotionNet is ~190 MB; the suite's disk is shared).
"""
import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch_port_parallel_common as P
from torch_port_parallel_common import KfoldSpectrograms

from emotiongestures_torch.cli import (
    test_emotion_gesture_diversity_iterative as eval_cli,
)
from emotiongestures_torch.cli import train_audio_classifier_K_fold as kfold
from emotiongestures_torch.cli import train_auxiliary as aux_cli
from emotiongestures_torch.cli import train_emotion_gesture as train_cli
from emotiongestures_torch.parallel import mesh
from emotiongestures_torch.utils.checkpoint import latest_step

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--d_model", "64", "--latent_dim", "128",
         "--gen_layers", "1"]
GAN = SMALL + ["--n_frames", "20", "--pose_dim", "12", "--save_every",
               "1000", "--prefetch", "0"]
GAN_KEYS = ("g_loss", "g_rec", "g_emo", "g_con", "g_adv", "d_loss")


@pytest.fixture(autouse=True)
def one_thread_and_cleanup(monkeypatch, tmp_path):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _gan(run_dir, *flags):
    return train_cli.main(train_cli.build_parser().parse_args(
        GAN + ["--model_save_path", str(run_dir), *flags]))


def _close(got, want, keys, rtol=2e-4):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-5,
                                   err_msg=k)


def test_gan_trainer_two_ranks_train_and_resume(tmp_path):
    """2 epochs of 4 steps, then --resume for one more: step 12 for G and
    D, checkpoints and one log written by rank 0."""
    run = tmp_path / "run"
    flags = ["--synthetic", "16", "--batch_size", "4", "--num_devices", "2"]
    gen, disc, first = _gan(run, *flags, "--total_epoch", "2")
    assert (gen, disc) == (None, None)  # the states live in the ranks
    assert first["steps"] == 8 and first["ranks"] == 2
    _, _, resumed = _gan(run, *flags, "--total_epoch", "1", "--resume")
    assert resumed["steps"] == 12
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    for net in ("generator", "discriminator"):
        assert latest_step(run / net) == 12
    log = (run / "train_emotion_gesture.log").read_text()
    assert log.count("done:") == 2 and "resumed from step 8" in log
    assert "[rank 1" not in log
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [10]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


MULTIHOST = """
import json, sys
from emotiongestures_torch.cli import train_emotion_gesture as cli
_, _, summary = cli.main(cli.build_parser().parse_args(sys.argv[1:]))
print("SUMMARY " + json.dumps(summary["metrics"]))
"""


def test_gan_trainer_two_ranks_match_one_process(tmp_path):
    """One step on a global batch of 8: --num_devices 2, and two processes
    started with the multi-host flags, against one process."""
    flags = ["--synthetic", "8", "--batch_size", "8", "--total_epoch", "1"]
    # the two multi-host processes run while this one computes the others
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST, *GAN, *flags, "--model_save_path",
         str(tmp_path / "mh"), "--coordinator_address", f"localhost:{port}",
         "--num_processes", "2", "--process_id", str(i)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    try:
        _, _, one = _gan(tmp_path / "one", *flags)
        _, _, two = _gan(tmp_path / "two", *flags, "--num_devices", "2")
        assert one["steps"] == two["steps"] == 1
        _close(two["metrics"], one["metrics"], GAN_KEYS)
        for p in procs:
            out, err = p.communicate(timeout=P.TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    got = [json.loads(line[len("SUMMARY "):]) for out in outs
           for line in out.splitlines() if line.startswith("SUMMARY ")]
    assert len(got) == 2
    for metrics in got:
        _close(metrics, two["metrics"], GAN_KEYS)
    assert latest_step(tmp_path / "mh" / "generator") == 1


def test_aux_trainer_two_ranks_match_one_process(tmp_path):
    def run(name, *extra):
        return aux_cli.main(aux_cli.build_parser().parse_args(
            SMALL + ["--model", "fgd", "--synthetic", "8", "--batch_size",
                     "8", "--total_epoch", "1", "--model_save_path",
                     str(tmp_path / name), *extra]))

    _, one = run("one")
    state, two = run("two", "--num_devices", "2")
    assert state is None and one["steps"] == two["steps"] == 1
    _close(two["metrics"], one["metrics"], ("loss",))
    assert latest_step(tmp_path / "two" / "fgd") == 1


KFOLD = ["--device", "cpu", "--synthetic", "40", "--batch_size", "8",
         "--max_folds", "1", "--total_epoch", "1"]


def test_kfold_two_ranks_match_one_process(tmp_path, monkeypatch):
    """One fold of 4 steps; the two ranks also validate and checkpoint at
    step 4 (the validation changes no state). The ranks run the CLI's main
    in a group `launch` started (the module's dataset swapped for
    KfoldSpectrograms (16 x 16) in each rank); main joins it."""
    monkeypatch.setattr(kfold, "SyntheticGestureDataset", KfoldSpectrograms)
    ranks, one = P.alongside(
        lambda: mesh.launch(P.kfold_rank, 2, KFOLD + [
            "--model_save_path", str(tmp_path / "two"), "--num_devices", "2",
            "--eval_every", "4"], device="cpu", threads=1, timeout=P.TIMEOUT),
        lambda: kfold.main(kfold.build_parser().parse_args(
            KFOLD + ["--model_save_path", str(tmp_path / "one")])))
    for got in ranks:
        (g,) = got
        assert g["fold"] == 0 and g["step"] == one[0]["state"].step == 4
        assert g["test_acc"] == one[0]["test_acc"]
        assert np.array_equal(g["confusion"], one[0]["confusion"])
    assert latest_step(tmp_path / "two") == 4
    log = (tmp_path / "two" / "train_audio_classifier_K_fold.log").read_text()
    assert log.count("Test Accuracy") == 2  # the fold's line and the summary


def test_eval_cli_two_ranks_match_one_process(tmp_path):
    """2 batches of 8, beat alignment on, 2 diversity passes: rank 0's
    metrics against one process, with test_torch_port_eval.py's
    tolerances (l2, mpjre, diversity rtol 1e-5; FGD rtol 1e-4; Emotion-Acc
    equal; beat atol 1e-3)."""
    def run(*extra):
        return eval_cli.main(eval_cli.build_parser().parse_args(
            SMALL + ["--synthetic", "16", "--test_batch_size", "8",
                     "--num_diversity_passes", "2", "--log_save_path",
                     str(tmp_path), *extra]))

    one = run()
    two = run("--num_devices", "2")
    for key in ("l2", "mpjre_deg", "diversity"):
        np.testing.assert_allclose(two[key], one[key], rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(two["fgd"], one["fgd"], rtol=1e-4)
    np.testing.assert_allclose(two["beat"], one["beat"], atol=1e-3)
    assert two["emotion_acc"] == one["emotion_acc"]
    assert two["timings"]["eval_batch_calls"] == 4  # 2 batches x 2 passes
