"""Structured logging (the `get_logger` of `streamchat_tpu/utils/logging.py`,
copied: that module loads jax through its package's `__init__`).

Replaces the reference's ad-hoc ANSI `print`s with the stdlib logging
module: the package's root logger gets one stream handler, once.
"""

from __future__ import annotations

import logging

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "streamchat_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logging.getLogger("streamchat_tpu_torch").handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root = logging.getLogger("streamchat_tpu_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
    return logger
