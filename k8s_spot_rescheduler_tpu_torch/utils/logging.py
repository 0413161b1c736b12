"""Leveled logging in the style of the reference's glog usage.

The reference logs at -v=2 (state transitions, rescheduler.go:168, 266,
278), -v=3 (tick start/finish, 183, 289) and -v=4 (per-(pod,node) predicate
failures, 348). ``vlog(level, ...)`` reproduces that: messages are emitted
when the configured verbosity is >= level.
"""

from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("spot_rescheduler_tpu")
_verbosity = 0


def setup(verbosity: int = 0, stream=None) -> None:
    """Configure stderr logging (the reference forces logtostderr=true,
    rescheduler.go:93-96)."""
    global _verbosity
    _verbosity = verbosity
    if not _logger.handlers:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname).1s %(message)s")
        )
        _logger.addHandler(handler)
    _logger.setLevel(logging.DEBUG)


def verbosity() -> int:
    return _verbosity


def vlog(level: int, msg: str, *args) -> None:
    if _verbosity >= level:
        _logger.info(msg, *args)


def info(msg: str, *args) -> None:
    _logger.info(msg, *args)


def warning(msg: str, *args) -> None:
    _logger.warning(msg, *args)


def error(msg: str, *args) -> None:
    _logger.error(msg, *args)
