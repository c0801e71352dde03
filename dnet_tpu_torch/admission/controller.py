"""Bounded admission with load shedding, deadlines, and graceful drain.

Counterpart of dnet_tpu/admission/controller.py, the whole controller (the
chaos harness's `admit` injection point aside: chaos is not ported).  It
gates the serving path's concurrency in place of an unbounded
`asyncio.Semaphore`, with the admission-aware front end a fixed set of
batch slots / a paged-KV block pool needs:

- **Bounded wait queue** — at most ``DNET_ADMIT_QUEUE_DEPTH`` requests
  wait for a slot; the next one is shed *immediately* with
  `AdmissionRejected(reason="queue_full")`, which the HTTP layer maps to
  429 + ``Retry-After``.  Queued requests that outwait
  ``DNET_ADMIT_QUEUE_TIMEOUT_S`` shed with ``queue_timeout``.
- **Deadline-aware shedding** — a request whose *estimated* queue wait
  (from the observed per-request service-time EMA) already exceeds its
  deadline is shed at arrival (``reason="deadline"``) instead of queueing
  toward certain failure.
- **Retry-After from the observed service rate** — every rejection
  carries ``retry_after_s`` derived from the service-time EMA and the
  current queue, so well-behaved clients back off by exactly the time a
  slot should take to appear, not by a magic constant.
- **Drain mode** — `begin_drain()` flips the controller into shutdown:
  new arrivals shed with ``draining`` (HTTP 503 + Retry-After), queued
  waiters are failed fast, and `wait_drained()` bounds how long in-flight
  requests may finish (``DNET_DRAIN_DEADLINE_S``) before the caller
  proceeds to tear adapters down.

Slot accounting uses direct handoff: `release()` passes the freed slot to
the oldest waiter without ever letting `_active` dip below capacity, so a
same-tick arrival cannot barge past the queue.  Everything runs on the
event loop — no locks.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional

from dnet_tpu_torch.admission.reasons import DEADLINE_STAGES, REJECT_REASONS
from dnet_tpu_torch.obs import metric
from dnet_tpu_torch.obs.events import log_event
from dnet_tpu_torch.resilience import chaos
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

_QUEUE_DEPTH = metric("dnet_admit_queue_depth")
_INFLIGHT = metric("dnet_admit_inflight")
_ADMITTED = metric("dnet_admit_admitted_total")
_REJECTED = metric("dnet_admit_rejected_total")
_WAIT_MS = metric("dnet_admit_wait_ms")
_DEADLINE_EXCEEDED = metric("dnet_deadline_exceeded_total")
_DRAIN_STATE = metric("dnet_drain_state")


class AdmissionRejected(Exception):
    """A request shed at admission.  `reason` is one of
    `admission.reasons.REJECT_REASONS`; `retry_after_s` feeds the HTTP
    ``Retry-After`` header (429, or 503 while draining)."""

    def __init__(self, reason: str, message: str, retry_after_s: float) -> None:
        assert reason in REJECT_REASONS, reason
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


@dataclass(frozen=True)
class Deadline:
    """An absolute end-to-end request deadline.

    Wall clock (`time.time()`), not monotonic, because the deadline rides
    activation frame headers to other NODES (`ActivationFrame.deadline`)
    — a shard checks expiry against its own wall clock, so the check is
    accurate to cross-host NTP skew, which is orders of magnitude smaller
    than any sane deadline."""

    t_deadline: float  # epoch seconds

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.time() + float(seconds))

    @property
    def expired(self) -> bool:
        return time.time() >= self.t_deadline

    def remaining(self) -> float:
        return max(0.0, self.t_deadline - time.time())


def request_deadline(
    override_s: Optional[float], default_s: float
) -> Optional[Deadline]:
    """Resolve a request's deadline: per-request ``deadline_s`` override,
    else the ``DNET_REQUEST_DEADLINE_S`` default; 0/None disables."""
    seconds = default_s if override_s is None else override_s
    if not seconds or seconds <= 0:
        return None
    return Deadline.after(seconds)


def deadline_expired(stage: str) -> None:
    """Count one deadline expiry at `stage` (pre-touched label set)."""
    assert stage in DEADLINE_STAGES, stage
    _DEADLINE_EXCEEDED.labels(stage=stage).inc()


class _Slot:
    """Context manager pairing one successful `acquire` with its
    `release`, so a slot can never leak on an exception path.  Release
    feeds the admit->release wall time into the controller's service-time
    EMA (the denominator of every Retry-After estimate)."""

    def __init__(self, controller: "AdmissionController") -> None:
        self._controller = controller
        self._released = False
        self._t_admit = time.monotonic()

    async def __aenter__(self) -> "_Slot":
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._controller._observe_service(
                time.monotonic() - self._t_admit
            )
            self._controller.release()


class AdmissionController:
    # Retry-After bounds: never tell a client "0" (it would hammer), never
    # more than a minute (the queue picture a minute out is fiction)
    RETRY_AFTER_MIN_S = 1.0
    RETRY_AFTER_MAX_S = 60.0
    SERVICE_EMA_ALPHA = 0.2  # same smoothing as the ring-hop RTT EMA

    def __init__(
        self,
        max_concurrent: int,
        queue_depth: int = 32,
        queue_timeout_s: float = 10.0,
    ) -> None:
        self._default_capacity = max(int(max_concurrent), 1)
        self._capacity = self._default_capacity
        self.queue_depth = max(int(queue_depth), 0)
        self.queue_timeout_s = float(queue_timeout_s)
        self._active = 0
        self._waiters: Deque[asyncio.Future] = deque()
        self._service_ema_s = 0.0
        self._draining = False
        self._drained = asyncio.Event()
        _DRAIN_STATE.set(0.0)
        self._sync_gauges()

    # ---- introspection --------------------------------------------------
    @property
    def active(self) -> int:
        return self._active

    @property
    def queued(self) -> int:
        return len(self._waiters)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def draining(self) -> bool:
        return self._draining

    def _sync_gauges(self) -> None:
        _QUEUE_DEPTH.set(float(len(self._waiters)))
        _INFLIGHT.set(float(self._active))

    # ---- capacity -------------------------------------------------------
    def set_capacity(self, n: Optional[int]) -> None:
        """Re-cap admission (a batched engine's slot pool: admitting more
        requests than slots would fail the overflow instead of queueing
        it).  None
        restores the configured default.  Requests already admitted finish
        under the old cap — `release` simply stops waking waiters while
        `_active` exceeds the new one."""
        cap = (
            self._default_capacity
            if n is None
            else min(int(n), self._default_capacity)
        )
        self._capacity = max(cap, 1)
        # a RAISED cap admits queued waiters right now.  Each wake grants
        # a NEW slot — `_active` must count it — unlike release's
        # `_wake_one`, which hands over an existing slot already counted.
        while self._waiters and self._active < self._capacity:
            fut = self._waiters.popleft()
            if not fut.done():
                self._active += 1
                fut.set_result(True)
        self._sync_gauges()

    # ---- service-rate observation --------------------------------------
    def _observe_service(self, dt_s: float) -> None:
        self._service_ema_s = (
            dt_s
            if self._service_ema_s <= 0
            else (1 - self.SERVICE_EMA_ALPHA) * self._service_ema_s
            + self.SERVICE_EMA_ALPHA * dt_s
        )

    def estimated_wait_s(self, position: int) -> float:
        """Expected queue wait for a request at `position` (0 = front),
        from the observed per-request service-time EMA: with `capacity`
        servers each turning a slot over every `ema` seconds, the
        (position+1)-th waiter starts after ~ceil((position+1)/capacity)
        turnovers.  0 before any request completed (optimistic: the first
        requests must not be shed on no evidence)."""
        if self._service_ema_s <= 0:
            return 0.0
        turnovers = -(-(position + 1) // self._capacity)  # ceil div
        return self._service_ema_s * turnovers

    def retry_after_s(self) -> float:
        """Seconds a shed client should wait before retrying: the
        estimated wait for the CURRENT backlog to clear one slot."""
        est = self.estimated_wait_s(len(self._waiters))
        return min(max(est, self.RETRY_AFTER_MIN_S), self.RETRY_AFTER_MAX_S)

    # ---- admission ------------------------------------------------------
    def _reject(self, reason: str, message: str) -> AdmissionRejected:
        _REJECTED.labels(reason=reason).inc()
        retry_after_s = self.retry_after_s()
        log_event(
            "shed", reason=reason,
            retry_after_s=round(retry_after_s, 3),
            queued=len(self._waiters), inflight=self._active,
        )
        return AdmissionRejected(reason, message, retry_after_s)

    def _admit(self, wait_s: float = 0.0) -> _Slot:
        _ADMITTED.inc()
        _WAIT_MS.observe(wait_s * 1000.0)
        log_event(
            "admitted", wait_ms=round(wait_s * 1000.0, 3),
            queued=len(self._waiters), inflight=self._active,
        )
        self._sync_gauges()
        return _Slot(self)

    async def acquire(self, deadline: Optional[Deadline] = None) -> _Slot:
        """Admit the calling request or raise `AdmissionRejected`.

        Prefer ``async with controller.slot(...)`` — it guarantees the
        release.  The chaos point ``admit`` sits first, so an injected
        delay backs the queue up exactly like a slow burst would."""
        await chaos.inject_async("admit")
        if self._draining:
            raise self._reject("draining", "server is draining for shutdown")
        if deadline is not None and deadline.expired:
            deadline_expired("admission")
            raise self._reject("deadline", "request deadline already expired")
        if self._active < self._capacity and not self._waiters:
            self._active += 1
            return self._admit()
        if len(self._waiters) >= self.queue_depth:
            raise self._reject(
                "queue_full",
                f"admission queue full ({self.queue_depth} waiting, "
                f"{self._active} executing)",
            )
        est = self.estimated_wait_s(len(self._waiters))
        if deadline is not None and est > deadline.remaining():
            deadline_expired("admission")
            raise self._reject(
                "deadline",
                f"estimated queue wait {est:.1f}s exceeds the request "
                f"deadline ({deadline.remaining():.1f}s left)",
            )
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._waiters.append(fut)
        self._sync_gauges()
        timeout = self.queue_timeout_s
        deadline_cut = False
        if deadline is not None and deadline.remaining() < timeout:
            timeout = deadline.remaining()
            deadline_cut = True
        t0 = time.monotonic()
        try:
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._unqueue(fut)
            if deadline_cut:
                deadline_expired("admission")
                raise self._reject(
                    "deadline", "request deadline expired in the admission queue"
                ) from None
            raise self._reject(
                "queue_timeout",
                f"no slot within {self.queue_timeout_s:.1f}s "
                f"(DNET_ADMIT_QUEUE_TIMEOUT_S)",
            ) from None
        except asyncio.CancelledError:
            self._unqueue(fut)
            raise
        except AdmissionRejected:
            # drain failed the queued future itself
            self._sync_gauges()
            raise
        # slot handed over by release(); _active already counts us
        return self._admit(time.monotonic() - t0)

    def _unqueue(self, fut: asyncio.Future) -> None:
        """Remove a dead waiter; if `release` resolved it concurrently the
        handed-over slot must be passed on, not leaked."""
        try:
            self._waiters.remove(fut)
        except ValueError:
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                self.release()
        self._sync_gauges()

    def slot(self, deadline: Optional[Deadline] = None):
        """``async with controller.slot(deadline):`` — acquire + guaranteed
        release."""
        return _SlotAcquire(self, deadline)

    # ---- release --------------------------------------------------------
    def release(self) -> None:
        if self._active <= 0:
            log.warning("admission release without a matching acquire")
            return
        if self._waiters and self._active <= self._capacity and not self._draining:
            # direct handoff: the slot transfers without _active dipping,
            # so a same-tick arrival cannot barge past the queue
            self._wake_one()
        else:
            self._active -= 1
            if self._draining and self._active == 0:
                self._drained.set()
        self._sync_gauges()

    def _wake_one(self) -> None:
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(True)
                return
        # nobody viable took the handoff: the slot is simply free
        self._active -= 1
        if self._draining and self._active == 0:
            self._drained.set()

    # ---- drain ----------------------------------------------------------
    def begin_drain(self) -> None:
        """Enter drain: shed new arrivals and queued waiters with
        ``draining``; in-flight requests keep their slots."""
        if self._draining:
            return
        self._draining = True
        _DRAIN_STATE.set(1.0)
        log.info(
            "drain started: %d in flight, %d queued (queued are shed)",
            self._active, len(self._waiters),
        )
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                _REJECTED.labels(reason="draining").inc()
                log_event(
                    "shed", reason="draining",
                    queued=len(self._waiters), inflight=self._active,
                )
                fut.set_exception(
                    AdmissionRejected(
                        "draining",
                        "server is draining for shutdown",
                        self.retry_after_s(),
                    )
                )
        if self._active == 0:
            self._drained.set()
        self._sync_gauges()

    async def wait_drained(self, timeout_s: float) -> bool:
        """Block until every in-flight request released its slot, bounded
        by `timeout_s` (``DNET_DRAIN_DEADLINE_S``).  True = clean drain;
        False = deadline hit with work still in flight (the caller
        proceeds to shutdown regardless — bounded beats graceful)."""
        if not self._draining:
            self.begin_drain()
        try:
            await asyncio.wait_for(self._drained.wait(), timeout_s)
            return True
        except asyncio.TimeoutError:
            log.warning(
                "drain deadline (%.1fs) hit with %d request(s) in flight",
                timeout_s, self._active,
            )
            return False


class _SlotAcquire:
    """The awaitable-context form of acquire/release."""

    def __init__(
        self, controller: AdmissionController, deadline: Optional[Deadline]
    ) -> None:
        self._controller = controller
        self._deadline = deadline
        self._slot: Optional[_Slot] = None

    async def __aenter__(self) -> _Slot:
        self._slot = await self._controller.acquire(self._deadline)
        return self._slot

    async def __aexit__(self, *exc) -> None:
        if self._slot is not None:
            self._slot.release()
