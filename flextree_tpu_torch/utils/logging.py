"""Rank-tagged loggers.

The port's copy of the logger half of ``flextree_tpu/utils/logging.py``
(the result-file helpers stay with the JAX package's benchmark tools).
Multi-process attribution: when ``FT_RANK`` is set (the multi-process
launchers export it) every log line carries an ``r{rank}`` field, so
interleaved logs of several processes are attributable without grepping
PIDs; ``get_logger(rank=...)`` forces it for in-process callers.
"""

from __future__ import annotations

import logging
import os

__all__ = ["get_logger", "logger_rank"]

_FMT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"
_FMT_RANK = "%(asctime)s %(levelname).1s r{rank} %(name)s] %(message)s"


def logger_rank() -> int | None:
    """The rank the process-wide loggers should stamp, from ``FT_RANK``
    (exported by the multi-process launchers).  None when unset or
    unparsable — a single-process run stays unstamped."""
    raw = os.environ.get("FT_RANK", "").strip()
    try:
        return int(raw) if raw else None
    except ValueError:
        return None


def get_logger(name: str = "flextree", rank: int | None = None) -> logging.Logger:
    """A configured logger.  ``rank`` (or ambient ``FT_RANK``) adds an
    ``r{rank}`` field to the format — resolved when the logger's handler
    is FIRST built, matching the launcher contract that ``FT_RANK`` is
    exported before the child imports anything."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        if rank is None:
            rank = logger_rank()
        fmt = _FMT if rank is None else _FMT_RANK.format(rank=rank)
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(fmt))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("FT_LOG_LEVEL", "INFO"))
        logger.propagate = False
    return logger
