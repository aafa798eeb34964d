"""Logging setup matching the reference (utils/train_utils_BEAT.py:33-42):
stream + rotating file handler (10 MB x 5), DEBUG level, the same format.
A copy of emotiongestures_tpu/utils/logging.py::set_logger."""
from __future__ import annotations

import logging
import os
from logging.handlers import RotatingFileHandler


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
