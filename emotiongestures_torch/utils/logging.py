"""Logging setup matching the reference (utils/train_utils_BEAT.py:33-42):
stream + rotating file handler (10 MB x 5), DEBUG level, the same format,
and an append-only JSON-lines metric log. A copy of
emotiongestures_tpu/utils/logging.py's set_logger and MetricLogger.

Under data parallelism only the primary process writes: the other ranks
log warnings and errors to the stream and no file, and their MetricLogger
writes nothing."""
from __future__ import annotations

import json
import logging
import os
import time
from logging.handlers import RotatingFileHandler
from pathlib import Path

from ..parallel.distributed import is_primary, process_count, process_index


def set_logger(log_path=None, log_filename: str = "log"):
    for handler in logging.root.handlers[:]:
        logging.root.removeHandler(handler)
    handlers = [logging.StreamHandler()]
    if not is_primary():
        logging.basicConfig(
            level=logging.WARNING, handlers=handlers,
            format=f"%(asctime)s [rank {process_index()}/{process_count()}]"
                   f": %(message)s")
        return
    if log_path is not None:
        os.makedirs(log_path, exist_ok=True)
        handlers.append(
            RotatingFileHandler(
                os.path.join(log_path, log_filename),
                maxBytes=10 * 1024 * 1024, backupCount=5,
            )
        )
    logging.basicConfig(level=logging.DEBUG,
                        format="%(asctime)s: %(message)s", handlers=handlers)
    logging.getLogger("matplotlib").setLevel(logging.WARNING)


class MetricLogger:
    """Append-only JSONL scalar log, one line per call: {"step", "time",
    scalars...}, with the reference's scalar names (test_...py:261)."""

    def __init__(self, path):
        self.path = Path(path)
        if is_primary():
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, **scalars):
        if not is_primary():
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
