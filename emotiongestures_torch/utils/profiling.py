"""Tracing and profiling hooks (port of
emotiongestures_tpu/utils/profiling.py): torch.profiler traces as Chrome
traces, named regions, per-step timing on CUDA events, and a NaN/inf guard
behind EGTP_DEBUG_NANS=1.
"""
from __future__ import annotations

import contextlib
import logging
import math
import os
import tempfile
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """A torch.profiler trace of the block, CPU and (with a card) CUDA
    activity, written as a Chrome trace (`trace.json`, for Perfetto or
    chrome://tracing) into `log_dir` (EGTP_TRACE_DIR, else
    <tmp>/egtp_trace):

        with profiling.trace("runs/trace") as prof:
            train_step(...)
    """
    log_dir = Path(log_dir or os.environ.get(
        "EGTP_TRACE_DIR", os.path.join(tempfile.gettempdir(), "egtp_trace")))
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    logging.info("profiler trace written to %s", log_dir)


def named_scope(name: str):
    """A named region in profiler traces (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step time. On a CUDA device: a pair of CUDA events around each
    step, read once at the end (no sync per step), so a step's time is the
    device timeline between them. On the CPU: the host clock.

        timer = StepTimer(device)
        for ...:
            with timer:
                train_step(...)
        ms = timer.times_ms()
    """

    def __init__(self, device=None):
        self.cuda = torch.device(device or "cpu").type == "cuda"
        self._spans = []

    def __enter__(self):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            start = time.perf_counter()
        self._spans.append([start, None])
        return self

    def __exit__(self, *exc):
        if self.cuda:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
        else:
            stop = time.perf_counter()
        self._spans[-1][1] = stop
        return False

    def times_ms(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self._spans]
        return [(b - a) * 1e3 for a, b in self._spans]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def guard_finite(tree, name: str = "tree", enabled: bool | None = None):
    """Raise FloatingPointError on a non-finite leaf (tensors or numbers in
    nested dicts and lists) when enabled: EGTP_DEBUG_NANS=1, or
    `enabled=True`. A host-side check; each tensor leaf costs a sync."""
    if enabled is None:
        enabled = os.environ.get("EGTP_DEBUG_NANS", "0") == "1"
    if not enabled:
        return True
    for path, leaf in _leaves(tree):
        finite = (bool(torch.isfinite(leaf).all())
                  if isinstance(leaf, torch.Tensor)
                  else math.isfinite(float(leaf)))
        if not finite:
            raise FloatingPointError(f"non-finite values in {name}{path}")
    return True
