"""Retry with exponential backoff for the ring's RPCs.

A trimmed counterpart of dnet_tpu/resilience/policy.py: an error is
retried only when it looks transient (gRPC UNAVAILABLE / DEADLINE_EXCEEDED,
connection and timeout errors), up to DNET_TRANSPORT_SEND_RETRIES attempts
in all, with full-jitter backoff from DNET_TRANSPORT_STREAM_BACKOFF_S.
The token callback gets one attempt more: a lost token strands its
request until the timeout.
"""

from __future__ import annotations

import asyncio
import random
from typing import Awaitable, Callable

from dnet_tpu_torch.config import transport_settings
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

RETRYABLE_GRPC_CODES = frozenset({"UNAVAILABLE", "DEADLINE_EXCEEDED"})
MAX_DELAY_S = 2.0


def is_retryable(exc: BaseException) -> bool:
    code = getattr(exc, "code", None)
    if callable(code):
        try:
            name = getattr(code(), "name", None)
        except Exception:
            name = None
        if name is not None:
            return name in RETRYABLE_GRPC_CODES
    return isinstance(exc, (ConnectionError, TimeoutError, OSError, asyncio.TimeoutError))


async def call_with_retry(
    fn: Callable[[], Awaitable],
    *,
    method: str,
):
    """Await fn(), retrying transient failures; the last error propagates."""
    s = transport_settings()
    attempts = max(int(s.send_retries), 1) + (1 if method == "send_token" else 0)
    base = max(float(s.stream_backoff_s), 0.0)
    for attempt in range(attempts):
        try:
            return await fn()
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            if attempt + 1 >= attempts or not is_retryable(exc):
                raise
            delay = random.uniform(0.0, min(base * 2**attempt, MAX_DELAY_S))
            log.warning("%s failed (%s); retry %d/%d in %.2fs", method, exc, attempt + 1,
                        attempts - 1, delay)
            await asyncio.sleep(delay)
