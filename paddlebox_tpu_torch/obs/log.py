"""Rank-prefixed structured log lines (paddlebox_tpu/obs/log.py:12-118).

Every line gets a ``[pbtpu rN HH:MM:SS]`` prefix and sorted ``key=value``
fields, lands on stderr (resolved at emit time, so a swapped sys.stderr
captures it) through the logger "paddlebox_tpu_torch.obs", and each
warning or error line counts into the stat registry
(``log_warning_lines`` / ``log_error_lines``) and goes to the active
flight recorder (obs/flight.py), if any.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional

from paddlebox_tpu_torch.utils.stats import stat_add

_RANK: Optional[int] = None
_LOGGER: Optional[logging.Logger] = None


def set_rank(rank: int) -> None:
    """Pin the prefix's rank (a rank program calls it once its fleet rank
    is known); before that PBTPU_RANK, else 0, applies."""
    global _RANK
    _RANK = int(rank)


def get_rank() -> int:
    """The rank of the prefix: set_rank's, else PBTPU_RANK, else 0."""
    if _RANK is not None:
        return _RANK
    try:
        return int(os.environ.get("PBTPU_RANK", "0"))
    except ValueError:
        return 0


class _StderrHandler(logging.StreamHandler):
    def __init__(self) -> None:
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr


class _StatTapHandler(logging.Handler):
    """Counts warning and error lines into the stat registry and forwards
    them to the active flight recorder."""

    def emit(self, record: logging.LogRecord) -> None:
        if record.levelno < logging.WARNING:
            return
        try:
            from paddlebox_tpu_torch.obs import flight
            stat_add("log_error_lines" if record.levelno >= logging.ERROR
                     else "log_warning_lines")
            fr = flight.active()
            if fr is not None:
                fr.on_log(record.levelname, record.getMessage())
        except Exception:  # noqa: BLE001 (the tap never breaks logging)
            pass


class _RankFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        stamp = time.strftime("%H:%M:%S", time.localtime(record.created))
        prefix = "[pbtpu r%d %s] " % (get_rank(), stamp)
        msg = record.getMessage()
        return "\n".join(prefix + ln for ln in msg.splitlines() or [""])


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        lg = logging.getLogger("paddlebox_tpu_torch.obs")
        if not lg.handlers:
            h = _StderrHandler()
            h.setFormatter(_RankFormatter())
            lg.addHandler(h)
            lg.addHandler(_StatTapHandler())
            lg.propagate = False
        if lg.level == logging.NOTSET:
            lg.setLevel(logging.INFO)
        _LOGGER = lg
    return _LOGGER


def _fmt(msg: str, fields: dict) -> str:
    if not fields:
        return msg
    tail = " ".join("%s=%s" % (k, fields[k]) for k in sorted(fields))
    return "%s %s" % (msg, tail) if msg else tail


def info(msg: str, **fields) -> None:
    get_logger().info(_fmt(msg, fields))


def warning(msg: str, **fields) -> None:
    get_logger().warning(_fmt(msg, fields))


def error(msg: str, **fields) -> None:
    get_logger().error(_fmt(msg, fields))
