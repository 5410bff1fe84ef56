"""Logging setup on stdlib ``logging``, and the TensorBoard writer.

Counterpart of ``dlmc_quant_tpu/utils/logging.py``: messages to stdout,
and with a log directory also to a rotating ``info.log`` there;
:class:`TensorboardWriter` is a silent no-op when disabled or when
``torch.utils.tensorboard`` does not import (the card's machine has no
tensorboard).
"""

from __future__ import annotations

import logging
import logging.config
import time
from pathlib import Path
from typing import Optional


def setup_logging(save_dir: Optional[Path], level: int = logging.INFO,
                  name: str = "dlmc") -> logging.Logger:
    handlers = {
        "console": {
            "class": "logging.StreamHandler",
            "level": "DEBUG",
            "formatter": "simple",
            "stream": "ext://sys.stdout",
        },
    }
    if save_dir is not None:
        handlers["info_file"] = {
            "class": "logging.handlers.RotatingFileHandler",
            "level": "INFO",
            "formatter": "datetime",
            "filename": str(Path(save_dir) / "info.log"),
            "maxBytes": 10 * 1024 * 1024,
            "backupCount": 20,
            "encoding": "utf8",
        }
    logging.config.dictConfig({
        "version": 1,
        "disable_existing_loggers": False,
        "formatters": {
            "simple": {"format": "%(message)s"},
            "datetime": {"format": "%(asctime)s - %(name)s - "
                                   "%(levelname)s - %(message)s"},
        },
        "handlers": handlers,
        "root": {"level": logging.getLevelName(level),
                 "handlers": list(handlers)},
    })
    return logging.getLogger(name)


class NoOp:
    """The logger of a non-zero rank: every call does nothing.
    ref: logger/logger.py:28-31"""

    def __getattr__(self, _name):
        def no_op(*args, **kwargs):
            pass
        return no_op


def get_logger(name: str, process_index: int = 0):
    """``name``'s logger at INFO; a :class:`NoOp` on a non-zero rank."""
    if process_index > 0:
        return NoOp()
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    return logger


class TensorboardWriter:
    """Tag-mode TensorBoard writer (``<tag>/<mode>``, with a
    ``steps_per_sec`` scalar at each ``set_step``); a no-op when disabled
    or without tensorboard.  ref: logger/visualization.py:5-78"""

    _TAG_METHODS = ("add_scalar", "add_scalars", "add_image", "add_images",
                    "add_audio", "add_text", "add_histogram", "add_pr_curve",
                    "add_embedding")

    def __init__(self, log_dir, logger=None, enabled: bool = True):
        self.writer = None
        if enabled and log_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(str(log_dir))
            except ImportError as e:
                if logger is not None:
                    logger.warning("tensorboard unavailable: %s", e)
        self.step = 0
        self.mode = ""
        self._timer = time.time()

    def set_step(self, step: int, mode: str = "train"):
        self.mode = mode
        self.step = step
        if step == 0:
            self._timer = time.time()
        else:
            dt = time.time() - self._timer
            if dt > 0:
                self._call("add_scalar", "steps_per_sec", 1.0 / dt)
            self._timer = time.time()

    def _call(self, method, tag, *args, **kwargs):
        if self.writer is None:
            return
        getattr(self.writer, method)(f"{tag}/{self.mode}" if self.mode
                                     else tag, *args,
                                     global_step=self.step, **kwargs)

    def __getattr__(self, name):
        if name in self._TAG_METHODS:
            def wrapped(tag, *args, **kwargs):
                self._call(name, tag, *args, **kwargs)
            return wrapped
        if name != "writer" and self.writer is not None:
            return getattr(self.writer, name)

        def no_op(*args, **kwargs):
            pass
        return no_op
