"""Logging setup on stdlib ``logging``.

Counterpart of ``setup_logging``/``get_logger`` in
``dlmc_quant_tpu/utils/logging.py``: messages to stdout, and with a log
directory also to a rotating ``info.log`` there.
"""

from __future__ import annotations

import logging
import logging.config
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


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    return logger
