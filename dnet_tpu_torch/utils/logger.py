"""Process-wide logger.

Counterpart of dnet_tpu/utils/logger.py, trimmed to one console handler:
`[PROFILE]` lines are dropped unless `obs_enabled()` (DNET_OBS_ENABLED or
DNET_PROFILE), and every record carries the identity bound by
`obs.events.bind` (rid / node / epoch / tick; `ContextStampFilter`).
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
        from dnet_tpu_torch.obs import obs_enabled

        return obs_enabled()


def setup_logger(role: Optional[str] = None, level: Optional[str] = None) -> logging.Logger:
    """Configure and return the process-wide logger (idempotent: a second
    call replaces the handler it installed)."""
    logger = logging.getLogger(_LOGGER_NAME)
    for h in list(logger.handlers):
        if getattr(h, "_dnet_owned", False):
            logger.removeHandler(h)
    logger.setLevel((level or os.environ.get("DNET_LOG_LEVEL", "INFO")).upper())
    logger.propagate = False
    from dnet_tpu_torch.obs.events import ContextStampFilter

    # logger-level stamp: every record through any handler carries the
    # bound rid/node/epoch/tick, exactly once
    if not any(isinstance(f, ContextStampFilter) for f in logger.filters):
        logger.addFilter(ContextStampFilter())
    fmt = logging.Formatter(
        f"%(asctime)s %(levelname)-7s %(name)s{'[' + role + ']' if role else ''}%(ctx)s %(message)s",
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
