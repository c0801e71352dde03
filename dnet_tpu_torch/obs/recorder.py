"""Per-request flight recorder: a bounded ring buffer of trace spans.

Counterpart of dnet_tpu/obs/recorder.py, the same recorder.

Every serving request (nonce == the OpenAI response id) accumulates spans —
ttft, per-decode-step, per-layer compute, transport send/recv, lane queue
wait, prefix-cache hits — as it flows through the API driver, the engine,
and the transport.  `GET /v1/debug/timeline/{rid}` (api/http.py) dumps one
request's timeline as JSON, replacing the string-grep-a-log-file workflow
the `[PROFILE]` lines forced.

Bounded both ways: at most `max_requests` request timelines (oldest evicted
first — a ring buffer over requests) and at most `max_spans` spans per
request (later spans are counted in `dropped`, never stored), so the
recorder's memory is O(1) regardless of traffic.  The defaults (64 x 2048)
cap worst-case retention at ~131k span dicts (~tens of MB); long
generations that out-span the cap keep their earliest spans and report the
tail in `dropped`.

Sampling under load (`DNET_OBS_TRACE_SAMPLE=N`, ObsSettings.trace_sample):
every Nth opened timeline is `sampled` and records its full span stream;
the rest keep ONLY forced summary spans (ttft, the closing request span)
and count everything else in `dropped` — so a load run's request flood
cannot thrash the 64-timeline ring into uselessness while still giving
RequestMetrics its per-request summary for every response.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
from collections import OrderedDict
from typing import Iterator, List, Optional

# Resume replays run under a fresh wire nonce `rid#rN`
# (resilience/checkpoint.py) so shard-side
# dedup and stream identity stay per-segment — but the STORY is one
# request.  The recorder aliases every segment nonce back to the base rid
# at write time, so `/v1/debug/timeline/{rid}` (and the trace export)
# shows admission -> failure -> resume -> finish as one timeline instead
# of fragments keyed by nonces no client ever saw.
_RESUME_NONCE_RE = re.compile(r"#r\d+$")


def base_rid(rid: str) -> str:
    """Strip a resume-segment suffix (`rid#rN` -> `rid`)."""
    return _RESUME_NONCE_RE.sub("", rid)


class FlightRecorder:
    def __init__(
        self,
        max_requests: int = 64,
        max_spans: int = 2048,
        sample_every: Optional[int] = None,
    ) -> None:
        if max_requests < 1 or max_spans < 1:
            raise ValueError("recorder bounds must be >= 1")
        self.max_requests = max_requests
        self.max_spans = max_spans
        # None = read ObsSettings.trace_sample lazily per opened timeline
        # (the process-global recorder is built before settings are)
        self.sample_every = sample_every
        self._opened = 0  # timelines ever opened (sampling phase counter)
        self._lock = threading.Lock()
        # rid -> {"t_unix", "t0" (perf_counter origin), "spans", "dropped",
        #         "sampled"}
        self._requests: "OrderedDict[str, dict]" = OrderedDict()

    def _sample_n(self) -> int:
        n = self.sample_every
        if n is None:
            from dnet_tpu_torch.config import obs_settings

            n = obs_settings().trace_sample
        return max(int(n), 1)

    def begin(self, rid: str) -> None:
        """Open (or re-open at the back of the ring) a request timeline."""
        with self._lock:
            self._begin_locked(base_rid(rid))

    def _begin_locked(self, rid: str) -> dict:
        entry = self._requests.get(rid)
        if entry is None:
            n = self._sample_n()
            entry = {
                "t_unix": time.time(),
                "t0": time.perf_counter(),
                "spans": [],
                "dropped": 0,
                # the 1st, N+1th, ... opened timeline records fully; the
                # rest keep only forced summary spans
                "sampled": self._opened % n == 0,
            }
            self._opened += 1
            self._requests[rid] = entry
            while len(self._requests) > self.max_requests:
                self._requests.popitem(last=False)
        else:
            self._requests.move_to_end(rid)
        return entry

    def span(
        self,
        rid: str,
        name: str,
        dur_ms: float,
        t_ms: Optional[float] = None,
        force: bool = False,
        **meta,
    ) -> None:
        """Record one completed span.  `t_ms` is the span's start offset
        from the request's first recorded activity; when omitted it is
        derived as now - dur (the common "time it, then record" shape).
        Unknown rids auto-open a timeline: shard- and transport-side spans
        arrive keyed by nonce with no driver to begin() for them.
        `force` bypasses the per-request span cap — for the few summary
        spans (ttft, the closing request span) that downstream consumers
        (RequestMetrics.from_timeline) must find even on generations long
        enough to out-span the cap.  Resume-segment nonces (`rid#rN`)
        alias to the base rid so a resumed request stays one timeline."""
        now = time.perf_counter()
        rid = base_rid(rid)
        with self._lock:
            entry = self._requests.get(rid)
            if entry is None:
                entry = self._begin_locked(rid)
                # backdate the origin: the request's first recorded
                # activity STARTED dur ago, so the first span lands at
                # t_ms=0, not -dur
                entry["t0"] = now - dur_ms / 1000.0
            else:
                # writing a span is activity: refresh the LRU position so
                # an in-flight long request outlives idle completed
                # timelines in the ring
                self._requests.move_to_end(rid)
            if not force and (
                not entry.get("sampled", True)
                or len(entry["spans"]) >= self.max_spans
            ):
                entry["dropped"] += 1
                return
            if t_ms is None:
                t_ms = max((now - entry["t0"]) * 1000.0 - dur_ms, 0.0)
            span = {"name": name, "t_ms": round(t_ms, 3),
                    "dur_ms": round(dur_ms, 3)}
            if meta:
                span["meta"] = meta
            entry["spans"].append(span)

    @contextlib.contextmanager
    def timed(self, rid: str, name: str, **meta) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.span(rid, name, (time.perf_counter() - t0) * 1000.0, **meta)

    def timeline(self, rid: str) -> Optional[dict]:
        """JSON-ready snapshot of one request's spans, or None."""
        rid = base_rid(rid)
        with self._lock:
            entry = self._requests.get(rid)
            if entry is None:
                return None
            return {
                "rid": rid,
                "t_unix": entry["t_unix"],
                "spans": [dict(s) for s in entry["spans"]],
                "dropped": entry["dropped"],
                "sampled": entry.get("sampled", True),
            }

    def request_ids(self) -> List[str]:
        with self._lock:
            return list(self._requests)

    def request_ids_since(self, t_unix: float) -> List[str]:
        """Rids whose timelines opened at or after `t_unix` (wall clock) —
        the serving-window selector behind `GET /v1/debug/trace?last_s=N`."""
        with self._lock:
            return [
                rid
                for rid, entry in self._requests.items()
                if entry["t_unix"] >= t_unix
            ]

    def clear(self) -> None:
        with self._lock:
            self._requests.clear()
            self._opened = 0  # sampling phase restarts with the ring
