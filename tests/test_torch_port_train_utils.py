"""The port's training utilities on the CPU, mirroring the JAX package's
tests/test_utils.py: checkpoint round trip, AsyncSaver's pruning and error
surfacing, the writer lock, GracefulShutdown, guard_finite, MetricLogger,
and the profiling hooks; plus the prefetcher's training keys and its
--cast_inputs cast, and the trainer's preset.
"""
import json
import os
import signal
import subprocess

import numpy as np
import pytest
import torch

from emotiongestures_torch.cli import train_emotion_gesture as train_cli
from emotiongestures_torch.cli.presets import GAN_TRAIN_FAST, apply_preset
from emotiongestures_torch.core import schedules
from emotiongestures_torch.data.pipeline import Prefetcher, place_batches
from emotiongestures_torch.data.synthetic import SyntheticGestureDataset
from emotiongestures_torch.train.state import TrainState
from emotiongestures_torch.utils import checkpoint as ckpt
from emotiongestures_torch.utils.logging import MetricLogger
from emotiongestures_torch.utils.profiling import (
    StepTimer,
    guard_finite,
    named_scope,
    trace,
)


class Small(torch.nn.Module):
    """A Linear and a BatchNorm: parameters, buffers and Adam state."""

    def __init__(self):
        super().__init__()
        from emotiongestures_torch.core.layers import BatchNorm

        self.fc = torch.nn.Linear(6, 4)
        self.bn = BatchNorm(4)

    def forward(self, x):
        return self.bn(self.fc(x))


def _state(seed=0):
    torch.manual_seed(seed)
    m = Small().train()
    return TrainState(m, schedules.adam(m.parameters(), lr=1e-2))


def _train(state, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        loss = state.module(torch.randn(8, 6, generator=g)).square().mean()
        state.apply_gradients(torch.autograd.grad(
            loss, list(state.module.parameters())))
    return state


def _same(a, b):
    for (n, x), y in zip(a.module.state_dict().items(),
                         b.module.state_dict().values()):
        assert torch.equal(x, y), n
    for pa, pb in zip(a.module.parameters(), b.module.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[pa][key],
                               b.optimizer.state[pb][key])


def test_checkpoint_roundtrip(tmp_path):
    state = _train(_state(), 3)
    path = ckpt.save_checkpoint(state, tmp_path / "ckpt")
    assert path.name == "checkpoint_iteration3.pt"
    assert ckpt.latest_step(tmp_path / "ckpt") == 3
    fresh, ok = ckpt.load_checkpoint(_state(seed=42), tmp_path / "ckpt")
    assert ok and fresh.step == 3
    _same(fresh, state)
    # the restored state trains on as the original does
    _same(_train(fresh, 1, seed=9), _train(state, 1, seed=9))
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"step", "model", "optimizer"}
    ckpt._release_writer_lock((tmp_path / "ckpt").absolute())


def test_load_checkpoint_missing(tmp_path):
    state = _state()
    restored, ok = ckpt.load_checkpoint(state, tmp_path / "nope")
    assert not ok and restored is state and state.step == 0


def test_async_saver_roundtrip_and_pruning(tmp_path):
    state = _state()
    with ckpt.AsyncSaver() as saver:
        for _ in range(4):
            _train(state, 1)
            saver.save(state, tmp_path / "ckpt", max_to_keep=2)
    kept = sorted(p.name for p in (tmp_path / "ckpt").iterdir()
                  if p.name.startswith("checkpoint_iteration"))
    assert kept == ["checkpoint_iteration3.pt", "checkpoint_iteration4.pt"]
    restored, ok = ckpt.load_checkpoint(_state(seed=42), tmp_path / "ckpt")
    assert ok and restored.step == 4
    _same(restored, state)
    ckpt._release_writer_lock((tmp_path / "ckpt").absolute())


def test_async_saver_copies_on_the_calling_thread(tmp_path):
    """The host copy is taken at save(): a later in-place update of the
    weights does not reach the checkpoint."""
    state = _train(_state(), 1)
    want = state.module.fc.weight.detach().clone()
    with ckpt.AsyncSaver() as saver:
        saver.save(state, tmp_path / "ckpt")
        with torch.no_grad():
            state.module.fc.weight.add_(1.0)
    raw = torch.load(tmp_path / "ckpt" / "checkpoint_iteration1.pt",
                     weights_only=True)
    assert torch.equal(raw["model"]["fc.weight"], want)
    ckpt._release_writer_lock((tmp_path / "ckpt").absolute())


def test_async_saver_surfaces_worker_errors():
    saver = ckpt.AsyncSaver()
    try:
        def boom():
            raise OSError("disk full")

        saver._pending = saver._executor.submit(boom)
        with pytest.raises(OSError, match="disk full"):
            saver.wait()
        saver._pending = saver._executor.submit(boom)
    finally:
        with pytest.raises(OSError, match="disk full"):
            saver.close()


def test_writer_lock_rejects_live_foreign_writer(tmp_path):
    state = _state()
    live = tmp_path / "live"
    live.mkdir()
    (live / ".egtp_writer.lock").write_bytes(b"1")  # pid 1 is alive
    with pytest.raises(RuntimeError, match="another live trainer"):
        ckpt.save_checkpoint(state, live)
    # a stale lock (the pid of a reaped child) is reclaimed
    dead = subprocess.Popen(["true"])
    dead.wait()
    stale = tmp_path / "stale"
    stale.mkdir()
    (stale / ".egtp_writer.lock").write_bytes(str(dead.pid).encode())
    assert ckpt.save_checkpoint(state, stale).exists()
    pid_s, _, token = ((stale / ".egtp_writer.lock").read_bytes().decode()
                       .partition(":"))
    assert int(pid_s) == os.getpid()
    assert token == ckpt._proc_start_token(os.getpid())
    ckpt.save_checkpoint(state, stale, step=7)  # re-entrant in-process
    assert ckpt.latest_step(stale) == 7
    ckpt._release_writer_lock(stale.absolute())
    assert not (stale / ".egtp_writer.lock").exists()
    ckpt._release_writer_lock(live.absolute())  # never acquired: no-op
    assert (live / ".egtp_writer.lock").exists()
    # a live pid whose start token is another process's: recycled, stale
    recycled = tmp_path / "recycled"
    recycled.mkdir()
    (recycled / ".egtp_writer.lock").write_bytes(b"1:999999999")
    assert ckpt._proc_start_token(1) != "999999999"
    assert ckpt.save_checkpoint(state, recycled).exists()
    ckpt._release_writer_lock(recycled.absolute())


def test_graceful_shutdown_flag():
    with ckpt.GracefulShutdown(signals=(signal.SIGUSR1,)) as stop:
        assert not stop.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert stop.requested
        assert signal.getsignal(signal.SIGUSR1) != stop._handler


def test_guard_finite():
    assert guard_finite({"a": torch.ones(3), "b": [1.0, 2.0]}, enabled=True)
    with pytest.raises(FloatingPointError, match=r"\['a'\]"):
        guard_finite({"a": torch.tensor([1.0, float("nan")])}, enabled=True)
    with pytest.raises(FloatingPointError):
        guard_finite({"loss": float("inf")}, enabled=True)
    assert guard_finite({"a": torch.tensor([float("nan")])}, enabled=False)


def test_guard_finite_follows_the_environment(monkeypatch):
    bad = {"a": torch.tensor([float("nan")])}
    monkeypatch.setenv("EGTP_DEBUG_NANS", "0")
    assert guard_finite(bad)
    monkeypatch.setenv("EGTP_DEBUG_NANS", "1")
    with pytest.raises(FloatingPointError):
        guard_finite(bad)


def test_metric_logger(tmp_path):
    log = MetricLogger(tmp_path / "m.jsonl")
    log.log(1, loss=0.5)
    log.log(2, loss=torch.tensor(0.25), acc=90.0)
    lines = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert lines[0]["step"] == 1 and lines[1]["acc"] == 90.0
    assert lines[1]["loss"] == 0.25 and "time" in lines[0]


def test_trace_named_scope_and_step_timer(tmp_path):
    state = _state()
    timer = StepTimer("cpu")
    with trace(tmp_path / "trace"):
        for _ in range(2):
            with timer, named_scope("egtp_step"):
                _train(state, 1)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "egtp_step" for e in events["traceEvents"])
    ms = timer.times_ms()
    assert len(ms) == 2 and all(t > 0 for t in ms)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batches_carry_the_training_keys_and_cast(prefetch):
    """The four training keys reach the step; with the --cast_inputs cast
    every float32 field is bf16 and the word ids stay integers."""
    ds = SyntheticGestureDataset(n_samples=4, seed=0)
    raw = ds.batches(2, shuffle=False, fields=train_cli.BATCH_KEYS)
    if prefetch:
        with Prefetcher(raw, "cpu", buffer_size=prefetch,
                        float_dtype=torch.bfloat16) as it:
            batches = list(it)
    else:
        batches = list(place_batches(raw, "cpu",
                                     float_dtype=torch.bfloat16))
    assert len(batches) == 2
    want = next(ds.batches(2, shuffle=False, fields=train_cli.BATCH_KEYS))
    for key in train_cli.BATCH_KEYS:
        t = batches[0][key]
        assert t.dtype == (torch.int32 if key == "text" else torch.bfloat16)
        np.testing.assert_allclose(t.float().numpy(), want[key],
                                   rtol=1e-2, atol=1e-2)


def test_fast_preset_expands_for_the_trainer():
    parser = train_cli.build_parser()
    args = apply_preset(parser.parse_args(["--preset", "fast"]), parser,
                        GAN_TRAIN_FAST, argv=["--preset", "fast"])
    assert (args.compute_dtype, args.update_order) == ("bfloat16", "g_first")
    argv = ["--preset", "fast", "--update_order", "d_first"]
    args = apply_preset(parser.parse_args(argv), parser, GAN_TRAIN_FAST,
                        argv=argv)
    assert (args.compute_dtype, args.update_order) == ("bfloat16", "d_first")
