"""Process-wide logger.

Counterpart of dnet_tpu/utils/logger.py, trimmed to one console handler:
`[PROFILE]` lines are dropped unless DNET_PROFILE=1.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_LOGGER_NAME = "dnet_tpu_torch"


class ProfileFilter(logging.Filter):
    """Drop `[PROFILE]` lines unless profiling is enabled."""

    def filter(self, record: logging.LogRecord) -> bool:
        if "[PROFILE]" not in record.getMessage():
            return True
        return os.environ.get("DNET_PROFILE", "0").lower() in ("1", "true", "yes")


def setup_logger(role: Optional[str] = None, level: Optional[str] = None) -> logging.Logger:
    """Configure and return the process-wide logger (idempotent: a second
    call replaces the handler it installed)."""
    logger = logging.getLogger(_LOGGER_NAME)
    for h in list(logger.handlers):
        if getattr(h, "_dnet_owned", False):
            logger.removeHandler(h)
    logger.setLevel((level or os.environ.get("DNET_LOG_LEVEL", "INFO")).upper())
    logger.propagate = False
    fmt = logging.Formatter(
        f"%(asctime)s %(levelname)-7s %(name)s{'[' + role + ']' if role else ''} %(message)s",
        datefmt="%H:%M:%S",
    )
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(fmt)
    console.addFilter(ProfileFilter())
    console._dnet_owned = True  # type: ignore[attr-defined]
    logger.addHandler(console)
    return logger


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        return setup_logger()
    return logger
