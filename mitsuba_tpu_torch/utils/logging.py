"""Logging with the reference's severities (mitsuba_tpu/utils/logging.py;
reference src/core/logger.cpp): a thin layer over Python's ``logging``
on the ``mitsuba_tpu_torch`` logger, which adds no handler of its own.
The JAX package's progress bar and profiling scopes wait for ROADMAP.md
Queue 1 item 8.
"""
from __future__ import annotations

import logging

Info = logging.INFO
Warn = logging.WARNING

_logger = logging.getLogger("mitsuba_tpu_torch")


def log(level, msg, *args):
    """Log(level, ...) analogue (logger.h Log macro)."""
    _logger.log(level, msg, *args)
