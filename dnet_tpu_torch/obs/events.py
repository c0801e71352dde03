"""Structured wide events: request-scoped context + the canonical ledger.

Counterpart of dnet_tpu/obs/events.py, the same journal.  The third
observability pillar next to metrics (obs/__init__.py) and traces
(obs/recorder.py + obs/trace.py): a dependency-free journal of structured
events riding the rid/epoch plumbing the serving path already threads
everywhere.

- **Context binding** — `bind(rid=, node=, epoch=, tick=)` establishes
  request identity for a dynamic extent via `contextvars`, so every
  `log_event()` AND every plain log line (the `ContextStampFilter`
  installed by utils/logger.py) inside the scope carries rid/node/epoch
  automatically.  The shard binds at frame dequeue (rid + epoch arrive on
  the ActivationFrame); thread hops propagate with
  `contextvars.copy_context()`.
- **Canonical events** — `log_event(name, **fields)` where `name` is one
  of `obs.phases.EVENT_NAMES` (asserted; the vocabulary is lint-checked
  against `dnet_events_total{name=}` both directions, pass DL030).  The
  wide `request_complete` event — exactly one per finished request — is
  emitted by api/inference.py with status, shed/finish reason, token
  counts, resolved modes, and the critical-path segment ledger embedded.
- **Sinks + query** — a bounded in-memory ring (DNET_OBS_EVENTS_RECORDS)
  behind `GET /v1/debug/events?rid=&name=&last_s=` on both roles, an
  optional JSONL file sink (DNET_OBS_EVENTS_PATH), and one
  `dnet_events_total{name=}` increment per event.  `?cluster=1` merges
  shard rings onto the API clock via the PR 2 offset probe
  (`merge_remote_events`).

Events store absolute wall time (`t_unix`, the cross-node join key the
clock stitcher corrects) — never monotonic time.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import threading
import time
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from dnet_tpu_torch.obs.phases import EVENT_NAMES

#: identity keys a binding may carry; log records and events expose them
#: under these exact names
CONTEXT_KEYS = ("rid", "node", "epoch", "tick")

_BOUND: contextvars.ContextVar[Optional[Dict[str, object]]] = (
    contextvars.ContextVar("dnet_event_ctx", default=None)
)


def bound_fields() -> Dict[str, object]:
    """The identity fields bound in the current context (copy; {} unbound)."""
    cur = _BOUND.get()
    return dict(cur) if cur else {}


@contextlib.contextmanager
def bind(rid=None, node=None, epoch=None, tick=None):
    """Bind request identity for the dynamic extent of the `with` block.

    Nested binds MERGE (inner non-None fields shadow outer ones), so the
    API can bind `node` at startup and `rid` per request.  The binding is
    a contextvar: it follows `await` chains for free and crosses explicit
    thread hops via `contextvars.copy_context().run(...)`.
    """
    fields: Dict[str, object] = {}
    for key, value in (
        ("rid", rid), ("node", node), ("epoch", epoch), ("tick", tick)
    ):
        if value is not None:
            fields[key] = value
    merged = {**(_BOUND.get() or {}), **fields}
    token = _BOUND.set(merged)
    try:
        yield merged
    finally:
        try:
            _BOUND.reset(token)
        except ValueError:
            # exited in a different Context than entered (a generator
            # holding the scope open across yields got finalized by the
            # event loop): the entry context is unreachable, so there is
            # nothing to restore — and nothing leaked into this one
            pass


class ContextStampFilter(logging.Filter):
    """Stamp the bound identity onto every log record.

    Installed at the LOGGER level by utils/logger.py setup_logger, so the
    ~45 `get_logger()` sites upgrade without touching a single call: any
    record emitted inside a `bind()` scope exposes `record.rid` /
    `record.node` / `record.epoch` / `record.tick` (empty string when
    unbound, so structured formatters never KeyError) plus `record.ctx`,
    a pre-rendered ` [rid=... node=...]` suffix for plain-text formats.
    """

    def filter(self, record: logging.LogRecord) -> bool:
        ctx = _BOUND.get() or {}
        parts = []
        for key in CONTEXT_KEYS:
            value = ctx.get(key)
            if getattr(record, key, None) in (None, ""):
                setattr(record, key, "" if value is None else value)
            if value not in (None, ""):
                parts.append(f"{key}={value}")
        record.ctx = " [" + " ".join(parts) + "]" if parts else ""
        return True


# ---- the event ring ----------------------------------------------------

class EventRing:
    """Bounded, thread-safe journal of event dicts (newest kept).

    Shard compute threads and the API event loop both append; queries
    copy under the lock and filter outside it.  Overflow EVICTS oldest
    and counts `dropped` — the debug surface reports the loss instead of
    silently looking complete.
    """

    def __init__(self, capacity: int) -> None:
        self.capacity = max(int(capacity), 1)
        self._events: Deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def append(self, event: dict) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(event)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def query(
        self,
        rid: str = "",
        name: str = "",
        last_s: float = 0.0,
        now: Optional[float] = None,
    ) -> List[dict]:
        """Filtered view, oldest first.  `rid` matches resume segments too
        (`rid#r1` rows join their base request); `last_s` > 0 keeps only
        events within that many seconds of `now`."""
        from dnet_tpu_torch.obs.recorder import base_rid

        with self._lock:
            events = list(self._events)
        if rid:
            events = [
                e for e in events if base_rid(str(e.get("rid", ""))) == rid
            ]
        if name:
            events = [e for e in events if e.get("name") == name]
        if last_s and last_s > 0:
            cutoff = (time.time() if now is None else now) - float(last_s)
            events = [e for e in events if float(e.get("t_unix", 0)) >= cutoff]
        return events


_ring: Optional[EventRing] = None
_ring_lock = threading.Lock()

# JSONL sink state (lazy-opened append handle; one warning then disabled
# on I/O failure so a full disk cannot take down serving)
_sink_lock = threading.Lock()
_sink_fh = None
_sink_path: Optional[str] = None
_sink_failed = False


def _obs_settings():
    from dnet_tpu_torch.config import obs_settings

    return obs_settings()


def get_event_ring() -> EventRing:
    """The process-wide ring, sized by DNET_OBS_EVENTS_RECORDS."""
    global _ring
    if _ring is None:
        with _ring_lock:
            if _ring is None:
                _ring = EventRing(_obs_settings().events_records)
    return _ring


def reset_events() -> None:
    """Drop the ring and close the sink (tests / reset_obs): the next
    log_event re-reads capacity and path from fresh settings."""
    global _ring, _sink_fh, _sink_path, _sink_failed
    with _ring_lock:
        _ring = None
    with _sink_lock:
        if _sink_fh is not None:
            try:
                _sink_fh.close()
            except OSError:
                pass
            _sink_fh = None
        _sink_path = None
        _sink_failed = False


def _sink_write(event: dict) -> None:
    global _sink_fh, _sink_path, _sink_failed
    path = _obs_settings().events_path
    if not path or _sink_failed:
        return
    with _sink_lock:
        try:
            if _sink_fh is None or _sink_path != path:
                if _sink_fh is not None:
                    _sink_fh.close()
                _sink_fh = open(path, "a", encoding="utf-8")
                _sink_path = path
            _sink_fh.write(json.dumps(event, default=str) + "\n")
            _sink_fh.flush()
        except OSError as exc:
            _sink_failed = True
            from dnet_tpu_torch.utils.logger import get_logger

            get_logger().warning(
                "events JSONL sink %s failed (%s); sink disabled for this "
                "process", path, exc,
            )


def log_event(name: str, **fields) -> dict:
    """Journal one canonical event: ring + optional JSONL sink + one
    `dnet_events_total{name=}` increment.

    `name` must be in `obs.phases.EVENT_NAMES` (the lint-checked
    vocabulary).  Identity fields (rid/node/epoch/tick) default from the
    current `bind()` scope; explicit kwargs win.  Returns the journaled
    record (tests and callers embedding it elsewhere)."""
    assert name in EVENT_NAMES, name
    event: Dict[str, object] = {"name": name, "t_unix": time.time()}
    ctx = _BOUND.get() or {}
    for key in CONTEXT_KEYS:
        value = fields.pop(key, ctx.get(key))
        if value is not None and value != "":
            event[key] = value
    event.update(fields)
    get_event_ring().append(event)
    _sink_write(event)
    from dnet_tpu_torch.obs import metric

    metric("dnet_events_total").labels(name=name).inc()
    return event


# ---- cluster merge -----------------------------------------------------

def merge_remote_events(
    local: Iterable[dict],
    remotes: Iterable[Tuple[str, Iterable[dict], object]],
) -> List[dict]:
    """Merge shard event lists onto the local clock, oldest first.

    `remotes` rows are `(node, events, ClockEstimate)` — the estimate from
    `obs.clock.offset_from_probe` over the fetch that carried the events
    (the response's `t_wall` doubles as the probe reading, exactly like
    the stitched timeline fetch).  Each remote `t_unix` is rebased by the
    estimated offset; every event is tagged with its owning `node` (local
    events that carry no node default to "api")."""
    merged: List[dict] = []
    for event in local:
        row = dict(event)
        row.setdefault("node", "api")
        merged.append(row)
    for node, events, est in remotes:
        offset_s = float(getattr(est, "offset_s", 0.0))
        for event in events:
            row = dict(event)
            row["node"] = node
            row["t_unix"] = float(row.get("t_unix", 0.0)) - offset_s
            merged.append(row)
    merged.sort(key=lambda e: float(e.get("t_unix", 0.0)))
    return merged
