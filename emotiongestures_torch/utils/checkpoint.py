"""Checkpoint save/load for the port's trainers (port of
emotiongestures_tpu/utils/checkpoint.py, in a torch-native format).

A checkpoint is one file, `<dir>/checkpoint_iteration<step>.pt` (the
reference's naming, train_...py:197-199), written by `torch.save`:
{"step": int, "model": module.state_dict(), "optimizer":
optimizer.state_dict()}, tensors only, so `load_checkpoint` reads it with
`torch.load(weights_only=True)`. The BatchNorm running statistics are part
of the model's state_dict. Writes go to a temporary name and are renamed on
commit, so a kill mid-write leaves nothing `latest_step` would pick up.

`AsyncSaver` copies the state to host memory on the calling thread and
writes on one worker thread; `GracefulShutdown` turns SIGTERM / SIGINT into
a flag the train loop polls; one writer process holds each checkpoint
directory (a lock file with its pid and /proc start-time token). Under data
parallelism only the primary process writes (a save on another rank
raises before it reaches the lock), every rank waits at a barrier after
each save, and on resume every rank reads the same file.

`load_checkpoint` and `load_model` also read the JAX package's orbax
`checkpoint_iteration<N>` directories (utils/orbax.py) where a directory
holds no `.pt` file, given the module's weight table.
"""
from __future__ import annotations

import atexit
import logging
import os
import re
import signal
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..parallel.distributed import is_primary, process_index
from .orbax import find_checkpoint

_NAME = re.compile(r"checkpoint_iteration(\d+)\.pt")
_LOCK = ".egtp_writer.lock"

# Directories this process holds the writer lock for (released atexit).
_HELD_LOCKS: set = set()


def _proc_start_token(pid: int) -> str | None:
    """Kernel start time of `pid` (clock ticks since boot, field 22 of
    /proc/<pid>/stat): tells a recycled pid from the original holder. None
    when unreadable (not Linux, process gone)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode("ascii", "replace")
        # comm (field 2) may hold spaces and parentheses: split after ")"
        return stat.rsplit(")", 1)[1].split()[19]
    except (OSError, IndexError):
        return None


def _parse_lock(content: bytes) -> tuple[int, str]:
    """Lock file layout: b"<pid>" or b"<pid>:<start_token>"."""
    text = content.decode(errors="replace").strip()
    pid_s, _, token = text.partition(":")
    try:
        return int(pid_s or "0"), token
    except ValueError:
        return 0, ""


def _holder_alive(pid: int, token: str) -> bool:
    if pid <= 0 or pid == os.getpid():
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass  # exists, owned by someone else
    if token:
        now = _proc_start_token(pid)
        if now is not None and now != token:
            return False  # the pid was recycled since the lock was written
    return True


def _primary_only() -> None:
    if not is_primary():
        raise RuntimeError(
            f"rank {process_index()} tried to write a checkpoint: only the "
            f"primary process writes")


def _acquire_writer_lock(directory: Path) -> None:
    """One writer process per checkpoint directory: two trainers sharing
    one prune each other's checkpoints. A lock held by a live process other
    than this one refuses; a stale one (dead pid, or a recycled pid whose
    start token differs) is reclaimed, and the reclaim is read back to
    check that this process won it."""
    directory = Path(directory)
    lock = directory / _LOCK
    token = _proc_start_token(os.getpid())
    me = (f"{os.getpid()}:{token}" if token else str(os.getpid())).encode()
    if directory in _HELD_LOCKS:
        if not lock.exists():  # the directory was emptied meanwhile
            lock.write_bytes(me)
        return
    for _ in range(8):
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
            with os.fdopen(fd, "wb") as f:
                f.write(me)
            break
        except FileExistsError:
            try:
                holder, h_token = _parse_lock(lock.read_bytes())
            except OSError:
                continue  # the lock vanished mid-read; try again
            if _holder_alive(holder, h_token):
                raise RuntimeError(
                    f"checkpoint directory {directory} is being written by "
                    f"another live trainer (pid {holder}); concurrent "
                    f"writers prune each other's checkpoints (max_to_keep) "
                    f"- point the second run at its own --model_save_path, "
                    f"or remove {lock} if the holder is not a trainer")
            tmp = directory / f"{_LOCK}.tmp-{os.getpid()}"
            tmp.write_bytes(me)
            os.replace(tmp, lock)
            try:
                if lock.read_bytes() == me:
                    break
            except OSError:
                pass  # lost the race; the loop checks the winner
    else:
        raise RuntimeError(
            f"could not acquire checkpoint writer lock {lock} after "
            f"repeated reclaim races - another trainer is contending")
    _HELD_LOCKS.add(directory)
    atexit.register(_release_writer_lock, directory)


def _release_writer_lock(directory: Path) -> None:
    directory = Path(directory)
    if directory not in _HELD_LOCKS:
        return
    _HELD_LOCKS.discard(directory)
    lock = directory / _LOCK
    try:
        if _parse_lock(lock.read_bytes())[0] == os.getpid():
            lock.unlink()
    except OSError:
        pass


def _host_copy(obj):
    """A copy of a (nested) state_dict with every tensor cloned to the
    host: training goes on updating the originals in place."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _state_tree(state) -> dict:
    return {"step": int(state.step),
            "model": _host_copy(state.module.state_dict()),
            "optimizer": _host_copy(state.optimizer.state_dict())}


def _write_tree(tree: dict, directory: Path, step: int,
                max_to_keep: int | None) -> Path:
    """Write `tree` as `directory/checkpoint_iteration{step}.pt` through a
    temporary file and a rename, then prune to the newest `max_to_keep`."""
    path = directory / f"checkpoint_iteration{step}.pt"
    tmp = directory / f".{path.name}.tmp-{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    if max_to_keep is not None:
        steps = sorted(_steps(directory))
        for old in steps[:-max_to_keep]:
            (directory / f"checkpoint_iteration{old}.pt").unlink(
                missing_ok=True)
    return path


def _steps(directory: Path) -> list:
    return [int(m.group(1)) for p in directory.iterdir()
            if (m := _NAME.fullmatch(p.name))]


def save_checkpoint(state, directory, step: int | None = None,
                    max_to_keep: int | None = 5) -> Path:
    """Write `state` (a train state: module, optimizer, step) under
    `directory`, keeping the newest `max_to_keep` (None keeps all).
    Blocking; a train loop uses AsyncSaver."""
    _primary_only()
    directory = Path(directory).absolute()
    directory.mkdir(parents=True, exist_ok=True)
    _acquire_writer_lock(directory)
    step = int(state.step) if step is None else int(step)
    return _write_tree(_state_tree(state), directory, step, max_to_keep)


class AsyncSaver:
    """Checkpoint writer for train loops that does not stall them: the copy
    to host memory runs on the calling thread (the next step updates the
    tensors in place), the write and the pruning on one worker thread. One
    save is in flight at a time; the next save, `wait()` or `close()`
    raises any error of the one before.

        saver = AsyncSaver()
        saver.save(state, ckpt_dir)   # returns after the host copy
        ...
        saver.close()                 # the final checkpoint is on disk
    """

    def __init__(self):
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="egtp-ckpt")
        self._pending = None

    def save(self, state, directory, step: int | None = None,
             max_to_keep: int | None = 5) -> None:
        _primary_only()
        directory = Path(directory).absolute()
        directory.mkdir(parents=True, exist_ok=True)
        _acquire_writer_lock(directory)
        step = int(state.step) if step is None else int(step)
        tree = _state_tree(state)
        self.wait()
        self._pending = self._executor.submit(
            _write_tree, tree, directory, step, max_to_keep)

    def wait(self) -> None:
        """Block until the save in flight is on disk; raise its error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._executor.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class GracefulShutdown:
    """SIGTERM / SIGINT set a flag that the train loop reads at step
    boundaries; it then saves a last checkpoint and exits cleanly. The
    handler puts the previous one back on the first signal, so a second
    signal kills as usual.

        with GracefulShutdown() as stop:
            for batch in ...:
                if stop.requested:
                    break
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._previous = {}
        self._event = threading.Event()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def _handler(self, signum, frame):
        self._event.set()
        signal.signal(signum, self._previous.get(signum, signal.SIG_DFL))

    def __enter__(self):
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            try:
                if signal.getsignal(s) == self._handler:
                    signal.signal(s, prev)
            except ValueError:
                pass
        return False


def latest_step(directory) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def _read(directory, step: int) -> dict:
    path = Path(directory).absolute() / f"checkpoint_iteration{step}.pt"
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model(module, directory, step: int | None = None,
               table=None) -> Path:
    """Load the model of a checkpoint into `module` (strict=True), the
    newest when `step` is None; no optimizer state is read. Returns what
    was read. For a frozen or evaluated network. A directory without the
    port's `.pt` files may hold the JAX package's orbax checkpoints, whose
    params and batch_stats load through `table` (utils.weights.jax_table)."""
    directory = Path(directory).absolute()
    if step is None:
        step = latest_step(directory)
    if step is not None and (directory / f"checkpoint_iteration{step}.pt"
                             ).exists():
        module.load_state_dict(_read(directory, step)["model"], strict=True)
        return directory / f"checkpoint_iteration{step}.pt"
    found = find_checkpoint(directory, step)
    if found is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    from .weights import load_orbax_model  # weights imports this module

    load_orbax_model(module, found, table)
    return found


def load_checkpoint(state, directory, step: int | None = None, table=None):
    """Restore a checkpoint into `state` in place (the newest when `step`
    is None). Returns (state, loaded?). The model's state_dict loads with
    strict=True; the optimizer's loads when it matches the state's
    optimizer, else the fresh one is kept with a warning (a checkpoint
    read with another optimizer config).

    A directory without the port's `.pt` files may hold the JAX package's
    orbax checkpoints (a trainer's `--resume` after training on the TPU):
    the step, the params and batch_stats through `table`
    (utils.weights.jax_table), and optax's Adam moments and count as the
    torch Adam's exp_avg, exp_avg_sq and step. An opt_state that does not
    match the optimizer leaves it fresh, with a warning, as the JAX
    package's load_checkpoint does."""
    pt_step = latest_step(directory) if step is None else step
    if pt_step is None or not (Path(directory).absolute() /
                               f"checkpoint_iteration{pt_step}.pt").exists():
        found = find_checkpoint(directory, step)
        if found is None:
            return state, False
        return _load_orbax_state(state, found, table), True
    raw = _read(directory, pt_step)
    state.module.load_state_dict(raw["model"], strict=True)
    state.step = int(raw["step"])
    try:
        state.optimizer.load_state_dict(raw["optimizer"])
    except (ValueError, KeyError):
        logging.getLogger(__name__).warning(
            "checkpoint optimizer state does not match - keeping the fresh "
            "optimizer state (model weights and step restored)")
    return state, True


def _load_orbax_state(state, path: Path, table):
    from .weights import adam_state_from_jax, load_orbax_model

    tree = load_orbax_model(state.module, path, table, full=True)
    state.step = int(tree["step"])
    variables = {"params": tree["params"],
                 "batch_stats": tree.get("batch_stats") or {}}
    try:
        state.optimizer.load_state_dict(adam_state_from_jax(
            state.optimizer, state.module, variables,
            tree.get("opt_state"), table))
    except (ValueError, KeyError, TypeError) as exc:
        logging.getLogger(__name__).warning(
            "checkpoint opt_state does not match the optimizer (%s) - "
            "keeping the fresh optimizer state (params, batch_stats and "
            "step restored)", exc)
    return state
