"""Cross-node clock-offset estimation and timeline stitching.

Counterpart of dnet_tpu/obs/clock.py, the same probe and stitcher.

Every process records flight-recorder spans against its OWN clocks (a wall
`t_unix` origin plus perf_counter offsets), so merging shard timelines into
one cluster view needs each node's wall-clock offset from the API node.
The estimator is the classic NTP midpoint: the client notes wall time `t0`
before a round trip, the server stamps its wall time `t_remote` while
serving, the client notes `t1` on return — assuming symmetric paths the
server stamped at the midpoint, so

    offset = t_remote - (t0 + t1) / 2        (remote clock minus local)

with worst-case error bounded by half the round trip.  Samples ride the
handshakes the cluster already makes — the gRPC MeasureLatency echo stamps
`t_remote` (shard/grpc_servicer.py), and every shard timeline HTTP
response carries `t_wall` so the fetch that collects a timeline IS the
offset probe for correcting it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ClockEstimate:
    """One node's estimated offset from the local clock, in seconds."""

    offset_s: float  # remote wall clock minus local wall clock
    rtt_s: float  # round trip the sample rode; error bound is rtt/2

    @property
    def error_bound_s(self) -> float:
        return self.rtt_s / 2.0


def offset_from_probe(t0: float, t_remote: float, t1: float) -> ClockEstimate:
    """NTP-style midpoint estimate from one round trip (wall seconds)."""
    if t1 < t0:
        raise ValueError(f"probe ended before it started (t0={t0}, t1={t1})")
    return ClockEstimate(offset_s=t_remote - (t0 + t1) / 2.0, rtt_s=t1 - t0)


class ClockSync:
    """Per-node offset table keeping each node's tightest (min-RTT) sample.

    A shorter round trip bounds the midpoint error tighter, so a new sample
    only replaces the stored one when its RTT is smaller — a congested
    probe cannot degrade an estimate a clean probe already produced.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._estimates: Dict[str, ClockEstimate] = {}

    def update(self, node: str, t0: float, t_remote: float, t1: float) -> ClockEstimate:
        est = offset_from_probe(t0, t_remote, t1)
        with self._lock:
            cur = self._estimates.get(node)
            if cur is None or est.rtt_s < cur.rtt_s:
                self._estimates[node] = est
                return est
            return cur

    def estimate(self, node: str) -> Optional[ClockEstimate]:
        with self._lock:
            return self._estimates.get(node)

    def offset_s(self, node: str) -> float:
        est = self.estimate(node)
        return est.offset_s if est is not None else 0.0

    def clear(self) -> None:
        with self._lock:
            self._estimates.clear()


def stitch_timelines(
    local: Optional[dict],
    remotes: Sequence[Tuple[str, dict, ClockEstimate]],
    local_node: str = "api",
    rid: str = "",
) -> dict:
    """Merge per-node flight-recorder timelines into one hop-annotated view.

    `local` is this process's `FlightRecorder.timeline()` dict (or None when
    only remote nodes recorded the rid); `remotes` are `(node, timeline,
    estimate)` triples fetched from shard HTTP servers.  Every span gains a
    `node` field, remote span times are rebased onto the LOCAL clock —
    absolute wall time of a span is `t_unix + t_ms/1000` on its own node,
    minus that node's offset to land in local time — and the merged spans
    sort by corrected start time, so hop ordering reads causally up to the
    residual estimator error (bounded by each probe's rtt/2).
    """
    base: Optional[float] = local.get("t_unix") if local else None
    if base is None:
        # no local timeline: rebase on the earliest corrected remote origin
        origins = [
            tl["t_unix"] - est.offset_s for _, tl, est in remotes if tl
        ]
        base = min(origins) if origins else 0.0

    spans: List[dict] = []
    dropped = 0
    nodes: List[dict] = []
    if local:
        for s in local["spans"]:
            spans.append({**s, "node": local_node})
        dropped += int(local.get("dropped", 0))
        nodes.append(
            {"node": local_node, "offset_ms": 0.0, "rtt_ms": 0.0,
             "spans": len(local["spans"]), "dropped": int(local.get("dropped", 0))}
        )
    for node, tl, est in remotes:
        if not tl:
            continue
        shift_ms = (tl["t_unix"] - est.offset_s - base) * 1000.0
        for s in tl["spans"]:
            spans.append({**s, "t_ms": round(s["t_ms"] + shift_ms, 3),
                          "node": node})
        dropped += int(tl.get("dropped", 0))
        nodes.append(
            {"node": node, "offset_ms": round(est.offset_s * 1000.0, 3),
             "rtt_ms": round(est.rtt_s * 1000.0, 3),
             "spans": len(tl["spans"]), "dropped": int(tl.get("dropped", 0))}
        )
    spans.sort(key=lambda s: s["t_ms"])
    return {
        "rid": (local or {}).get("rid") or rid,
        "t_unix": base,
        "cluster": True,
        "nodes": nodes,
        "spans": spans,
        "dropped": dropped,
    }
