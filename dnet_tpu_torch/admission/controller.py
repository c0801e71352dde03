"""Request deadlines at the serving path's front door.

Counterpart of dnet_tpu/admission/controller.py, trimmed to its deadline
part: `Deadline` (:73), `request_deadline` (:96) and the gate's expiry
check (`AdmissionController.acquire`, :268), with the Retry-After its
rejection carries, estimated from the observed service time as the
reference's.  The bounded wait queue, its shedding, drain mode and the
metrics are not ported: the port's InferenceManager still bounds
concurrency with a plain semaphore.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


class AdmissionRejected(Exception):
    """A request shed at admission (the port sheds only `deadline`);
    `retry_after_s` feeds the HTTP ``Retry-After`` header (429)."""

    def __init__(self, reason: str, message: str, retry_after_s: float) -> None:
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


@dataclass(frozen=True)
class Deadline:
    """An absolute end-to-end request deadline, on the wall clock
    (`time.time()`), because it rides activation frame headers to the
    shards, which check it against their own clocks."""

    t_deadline: float  # epoch seconds

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.time() + float(seconds))

    @property
    def expired(self) -> bool:
        return time.time() >= self.t_deadline

    def remaining(self) -> float:
        return max(0.0, self.t_deadline - time.time())


def request_deadline(override_s: Optional[float], default_s: float) -> Optional[Deadline]:
    """Resolve a request's deadline: per-request ``deadline_s`` override,
    else the ``DNET_REQUEST_DEADLINE_S`` default; 0/None disables."""
    seconds = default_s if override_s is None else override_s
    if not seconds or seconds <= 0:
        return None
    return Deadline.after(seconds)


class DeadlineGate:
    """The gate's expiry check, and the Retry-After of its rejection: the
    estimated time for one slot to turn over, from an EMA of admitted
    requests' service times (the reference's with an empty queue)."""

    RETRY_AFTER_MIN_S = 1.0
    RETRY_AFTER_MAX_S = 60.0
    SERVICE_EMA_ALPHA = 0.2

    def __init__(self) -> None:
        self._service_ema_s = 0.0

    def observe_service(self, dt_s: float) -> None:
        """Feed one admitted request's admit-to-release wall time."""
        a = self.SERVICE_EMA_ALPHA
        self._service_ema_s = dt_s if self._service_ema_s <= 0 else (1 - a) * self._service_ema_s + a * dt_s

    def retry_after_s(self) -> float:
        return min(max(self._service_ema_s, self.RETRY_AFTER_MIN_S), self.RETRY_AFTER_MAX_S)

    def check(self, deadline: Optional[Deadline]) -> None:
        """Raise `AdmissionRejected` for a request that arrives already
        past its deadline."""
        if deadline is not None and deadline.expired:
            raise AdmissionRejected("deadline", "request deadline already expired", self.retry_after_s())
