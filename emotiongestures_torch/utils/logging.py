"""Logging setup matching the reference (utils/train_utils_BEAT.py:33-42):
stream + rotating file handler (10 MB x 5), DEBUG level, the same format,
and an append-only JSON-lines metric log. A copy of
emotiongestures_tpu/utils/logging.py's set_logger and MetricLogger."""
from __future__ import annotations

import json
import logging
import os
import time
from logging.handlers import RotatingFileHandler
from pathlib import Path


def set_logger(log_path=None, log_filename: str = "log"):
    for handler in logging.root.handlers[:]:
        logging.root.removeHandler(handler)
    handlers = [logging.StreamHandler()]
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
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, **scalars):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
