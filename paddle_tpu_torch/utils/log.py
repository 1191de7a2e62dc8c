"""Logging wrapper — the port's copy of ``paddle_tpu/utils/log.py`` (the
reference's glog layer, paddle/utils/Logging.h).  The logger is named
``paddle_tpu_torch``; ``PADDLE_TPU_TORCH_LOGLEVEL`` sets its level."""

from __future__ import annotations

import logging
import os
import sys

__all__ = ["logger", "set_verbosity"]

logger = logging.getLogger("paddle_tpu_torch")

if not logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(
        logging.Formatter("%(levelname).1s %(asctime)s %(name)s] %(message)s", "%H:%M:%S")
    )
    logger.addHandler(_handler)
    logger.setLevel(os.environ.get("PADDLE_TPU_TORCH_LOGLEVEL", "INFO").upper())
    logger.propagate = False


def set_verbosity(level: str) -> None:
    logger.setLevel(level.upper())
