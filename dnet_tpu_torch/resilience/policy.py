"""Retry/backoff policy for the control and token planes.

Counterpart of dnet_tpu/resilience/policy.py, class for class.

Exponential backoff with FULL jitter (delay ~ U[0, base * mult^attempt],
capped), the spread AWS's backoff analysis recommends for thundering-herd
avoidance — after a shard restart every in-flight RPC retries at once, and
correlated retry waves are exactly what a recovering shard cannot absorb.

Classification: an error is retried only when it looks transient —
gRPC ``UNAVAILABLE`` / ``DEADLINE_EXCEEDED`` (duck-typed via ``.code()``
so fakes classify identically), connection/timeout errors, and injected
`ChaosError`s (a ConnectionError subclass, no import needed).  Everything
else (bad argument, compute error, cancellation) surfaces immediately.

Application map:

- `RingClient` unary RPCs retry here inside the transport client
  (transport/grpc_transport.py); ``health_check`` is pinned to ONE attempt — the
  failure monitor counts consecutive failures, and transport-level retries
  would silently stretch its detection window.
- The `ApiCallbackClient.send_token` path retries at its only call site,
  the shard adapter's ``_cb_send`` (shard/adapter.py), so injected fakes
  and the chaos ``token_cb`` point sit inside the retried callable.
- `StreamManager.send` re-opens broken bidi streams under the
  ``send_activation`` policy and re-sends the in-flight frame with its
  original seq (transport/stream_manager.py); the shard dedups on
  ``(nonce, seq, layer_id)``.
"""

from __future__ import annotations

import asyncio
import random
import threading
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

from dnet_tpu_torch.obs import metric
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

_RETRIES = metric("dnet_rpc_retries_total")

#: gRPC status names considered transient.
RETRYABLE_GRPC_CODES = frozenset({"UNAVAILABLE", "DEADLINE_EXCEEDED"})


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3       # total attempts, including the first
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: str = "full"        # "full" | "none"

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry number `attempt` (0-based).  With full
        jitter the delay is uniform over [0, capped exponential]."""
        raw = min(
            self.base_delay_s * (self.multiplier ** attempt), self.max_delay_s
        )
        if self.jitter == "full":
            return rng.uniform(0.0, raw)
        return raw


def policy_for(method: str) -> RetryPolicy:
    """The effective policy for an RPC class.  DNET_RESILIENCE_RETRY_*
    set the base policy for EVERY class; the two class adjustments that
    carry semantics are applied on top:

    - ``health_check`` is pinned to one attempt regardless of settings —
      the monitor's fail_threshold x interval IS the probe retry budget,
      and transport retries would silently stretch detection;
    - ``send_token`` gets one extra attempt — a lost token callback
      strands the whole request until its timeout, so the token path is
      worth one more try than bulk data-plane traffic;
    - ``load_model`` (the failure monitor's recovery reload) backs off on
      the scale of the operation — a whole-(delta-)cluster reload retried
      at unary-RPC cadence would hammer shards still tearing down the
      failed attempt, so its base delay is 20x the unary base.
    """
    from dnet_tpu_torch.config import resilience_settings

    s = resilience_settings()
    attempts = max(int(s.retry_attempts), 1)
    base = float(s.retry_base_s)
    max_delay = float(s.retry_max_s)
    if method == "health_check":
        attempts = 1
    elif method == "send_token":
        attempts += 1
    elif method == "load_model":
        base *= 20.0
        max_delay = max(max_delay, base)
    return RetryPolicy(
        max_attempts=attempts,
        base_delay_s=base,
        max_delay_s=max_delay,
    )


_rng: Optional[random.Random] = None
_rng_lock = threading.Lock()


def jitter_rng() -> random.Random:
    """The process jitter RNG; DNET_RESILIENCE_RETRY_JITTER_SEED != 0 makes
    backoff schedules reproducible."""
    global _rng
    if _rng is None:
        with _rng_lock:
            if _rng is None:
                from dnet_tpu_torch.config import resilience_settings

                seed = resilience_settings().retry_jitter_seed
                _rng = random.Random(seed) if seed else random.Random()
    return _rng


def reset_jitter_rng() -> None:
    """Drop the cached RNG so the next use re-reads the seed (tests)."""
    global _rng
    with _rng_lock:
        _rng = None


def is_retryable(exc: BaseException) -> bool:
    """Transient-failure classification (see module docstring)."""
    code = getattr(exc, "code", None)
    if callable(code):
        try:
            name = getattr(code(), "name", None)
        except Exception:
            name = None
        if name is not None:
            return name in RETRYABLE_GRPC_CODES
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return True
    return isinstance(exc, asyncio.TimeoutError)


async def call_with_retry(
    fn: Callable[[], Awaitable],
    *,
    method: str,
    policy: Optional[RetryPolicy] = None,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], Awaitable] = asyncio.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    retryable: Optional[Callable[[BaseException], bool]] = None,
):
    """Run `fn` under the method's retry policy.  Non-retryable errors and
    the final attempt's error propagate unchanged.  `retryable` overrides
    the transient-failure classifier for calls whose failures don't look
    like transport errors but ARE worth retrying (a recovery reload failing
    through an HTTP 500 is a cluster-state problem, not a logic bug)."""
    policy = policy or policy_for(method)
    rng = rng or jitter_rng()
    classify = retryable or is_retryable
    attempt = 0
    while True:
        try:
            return await fn()
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            if attempt + 1 >= policy.max_attempts or not classify(exc):
                raise
            _RETRIES.labels(method=method).inc()
            if on_retry is not None:
                on_retry(attempt, exc)
            log.warning(
                "%s failed (%s); retry %d/%d",
                method, exc, attempt + 1, policy.max_attempts - 1,
            )
            await sleep(policy.delay_s(attempt, rng))
            attempt += 1
