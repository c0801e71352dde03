"""SLO tracking: rolling-window availability and latency percentiles.

Counterpart of dnet_tpu/obs/slo.py, the same windows and gauges.

The registry's histograms aggregate since process start, which is the wrong
shape for "are we good *right now*": a night of fast decode buries a slow
last five minutes.  This module keeps bounded ring buffers of recent
observations (TTFT ms, decode-step ms, request outcomes) over a sliding
window and compares windowed p95 / availability against operator targets
(`DNET_OBS_SLO_*`, config.ObsSettings).  Burn state surfaces two ways:
`/health` flips to `status: degraded` naming the burning SLO(s), and the
`dnet_slo_*` gauges export the same numbers for alerting.

Boundary semantics (tested in tests/test_obs_slo.py): an SLO with target 0
is DISABLED; an empty window never burns (no evidence is not bad
evidence); and a value exactly AT its target is meeting it — burning is
strictly `p95 > target` / `availability < target`.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

SLO_TTFT = "ttft_p95_ms"
SLO_DECODE = "decode_p95_ms"
SLO_AVAILABILITY = "availability"
SLO_KINDS = (SLO_TTFT, SLO_DECODE, SLO_AVAILABILITY)


def nearest_rank(values: List[float], q: float) -> float:
    """THE nearest-rank quantile convention (0..1; empty -> 0.0), shared
    by the live SLO windows and the loadgen report so "report percentile"
    and "live gauge" are the same statistic over two vantage points."""
    if not 0.0 <= q <= 1.0:
        raise ValueError("q must be in [0, 1]")
    vals = sorted(values)
    if not vals:
        return 0.0
    rank = max(math.ceil(q * len(vals)), 1)
    return vals[rank - 1]


class RollingWindow:
    """Bounded (time, value) ring over the trailing `window_s` seconds.

    `max_events` caps memory under burst traffic; past it the oldest
    observation falls off early — the window then under-counts history, not
    the present, which is the right failure mode for an SLO."""

    def __init__(self, window_s: float = 300.0, max_events: int = 4096) -> None:
        if window_s <= 0 or max_events < 1:
            raise ValueError("window_s must be > 0 and max_events >= 1")
        self.window_s = window_s
        self._events: Deque[Tuple[float, float]] = deque(maxlen=max_events)
        self._lock = threading.Lock()

    def observe(self, value: float, now: Optional[float] = None) -> None:
        t = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((t, float(value)))

    def _values(self, now: Optional[float]) -> List[float]:
        t = time.monotonic() if now is None else now
        horizon = t - self.window_s
        with self._lock:
            while self._events and self._events[0][0] < horizon:
                self._events.popleft()
            return [v for _, v in self._events]

    def count(self, now: Optional[float] = None) -> int:
        return len(self._values(now))

    def percentile(self, q: float, now: Optional[float] = None) -> float:
        """Nearest-rank q-quantile (0..1) of the live window; 0.0 when
        empty (callers treat an empty window as "no evidence")."""
        return nearest_rank(self._values(now), q)

    def mean(self, now: Optional[float] = None) -> float:
        vals = self._values(now)
        return sum(vals) / len(vals) if vals else 0.0


@dataclass(frozen=True)
class SloStatus:
    name: str
    value: float
    target: float  # 0 = disabled
    samples: int
    burning: bool

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "value": round(self.value, 3),
            "target": self.target,
            "samples": self.samples,
            "burning": self.burning,
        }


class SloTracker:
    """Windows + targets + the `dnet_slo_*` gauge exports."""

    def __init__(
        self,
        window_s: float = 300.0,
        ttft_p95_ms: float = 0.0,
        decode_p95_ms: float = 0.0,
        availability: float = 0.0,
        max_events: int = 4096,
    ) -> None:
        from dnet_tpu_torch.obs import metric

        if window_s <= 0:
            # same "0 disables" convention as the sibling DNET_OBS_SLO_*
            # target knobs: keep a tiny live window but zero every target,
            # so a disabled-window config can never crash the serving path
            window_s, ttft_p95_ms, decode_p95_ms, availability = 1.0, 0, 0, 0
        self.window_s = window_s
        self.targets = {
            SLO_TTFT: float(ttft_p95_ms),
            SLO_DECODE: float(decode_p95_ms),
            SLO_AVAILABILITY: float(availability),
        }
        self._ttft = RollingWindow(window_s, max_events)
        self._decode = RollingWindow(window_s, max_events)
        self._outcomes = RollingWindow(window_s, max_events)  # 1 ok / 0 err
        self._g_ttft = metric("dnet_slo_ttft_p95_ms")
        self._g_decode = metric("dnet_slo_decode_p95_ms")
        self._g_avail = metric("dnet_slo_availability")
        self._g_burning = metric("dnet_slo_burning")
        # p99 twins (informational): loadgen cross-checks its client-side
        # tail percentiles against these; attainment stays p95-based
        self._g_ttft_p99 = metric("dnet_slo_ttft_p99_ms")
        self._g_decode_p99 = metric("dnet_slo_decode_p99_ms")

    # -- recording (hot path: one deque append under a lock) -------------
    def record_ttft(self, ms: float, now: Optional[float] = None) -> None:
        self._ttft.observe(ms, now)

    def record_decode(self, ms: float, now: Optional[float] = None) -> None:
        self._decode.observe(ms, now)

    def record_request(self, ok: bool, now: Optional[float] = None) -> None:
        self._outcomes.observe(1.0 if ok else 0.0, now)

    # -- evaluation -------------------------------------------------------
    def statuses(self, now: Optional[float] = None) -> List[SloStatus]:
        # ONE time snapshot for every window read below: count() and
        # mean()/percentile() each prune at their own horizon, so separate
        # clock reads could let the window's last events expire between
        # the two calls — reporting value 0.0 with samples > 0 and
        # spuriously flipping /health to degraded
        now = time.monotonic() if now is None else now
        out = []
        for name, window, higher_is_bad in (
            (SLO_TTFT, self._ttft, True),
            (SLO_DECODE, self._decode, True),
        ):
            target = self.targets[name]
            samples = window.count(now)
            value = window.percentile(0.95, now)
            burning = bool(target > 0 and samples > 0 and value > target)
            out.append(SloStatus(name, value, target, samples, burning))
        target = self.targets[SLO_AVAILABILITY]
        samples = self._outcomes.count(now)
        value = self._outcomes.mean(now) if samples else 1.0
        burning = bool(target > 0 and samples > 0 and value < target)
        out.append(SloStatus(SLO_AVAILABILITY, value, target, samples, burning))
        return out

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Evaluate every SLO, refresh the gauges, and return the /health
        payload: windowed values, targets, and which SLOs are burning."""
        # one clock read shared by the p95 statuses and the p99 reads, for
        # the same expiry-race reason statuses() documents
        now = time.monotonic() if now is None else now
        statuses = self.statuses(now)
        by_name = {s.name: s for s in statuses}
        self._g_ttft.set(by_name[SLO_TTFT].value)
        self._g_decode.set(by_name[SLO_DECODE].value)
        self._g_avail.set(by_name[SLO_AVAILABILITY].value)
        ttft_p99 = self._ttft.percentile(0.99, now)
        decode_p99 = self._decode.percentile(0.99, now)
        self._g_ttft_p99.set(ttft_p99)
        self._g_decode_p99.set(decode_p99)
        for s in statuses:
            self._g_burning.labels(slo=s.name).set(1.0 if s.burning else 0.0)
        return {
            "window_s": self.window_s,
            "slos": [s.as_dict() for s in statuses],
            "burning": [s.name for s in statuses if s.burning],
            "p99": {
                "ttft_ms": round(ttft_p99, 3),
                "decode_ms": round(decode_p99, 3),
            },
        }

    def burning(self, now: Optional[float] = None) -> List[str]:
        return [s.name for s in self.statuses(now) if s.burning]
