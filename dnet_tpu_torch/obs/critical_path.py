"""Critical-path attribution: span timelines -> exhaustive segment ledger.

Counterpart of dnet_tpu/obs/critical_path.py, the same ledger.

A BENCH_SERVE record tells you p99 E2E moved; the FlightRecorder tells you
which spans a request recorded.  Neither answers WHERE the p99 lives — the
spans overlap (a `decode_step` umbrella covers the hop RTT which covers the
shard compute which covers the sampler), so summing them double-counts and
grepping them by eye does not scale past one request.  This module
decomposes one request's recorded spans — a local timeline or a
cluster-stitched one (obs/clock.py stitch_timelines) — into the exhaustive,
non-overlapping segment ledger declared in obs/phases.py REQUEST_SEGMENTS:
every wall-clock millisecond between admission and the closing `request`
span is attributed to EXACTLY one segment, most-specific span wins, and
recorded time no span claims lands in `other` instead of vanishing.

The attribution rule is a priority sweep: spans are mapped to
(segment, specificity) by name, the window is cut at every span boundary,
and each elementary slice goes to the most specific span covering it.
`decode_step` (the API driver's per-token umbrella) is least specific;
`hop_rtt` (send->resolve, which contains the remote shard's whole story)
outranks it; shard compute / prefill outrank the hop; leaf work (sampling,
codec encode, stream writes, SSE flushes) and queue waits outrank
everything.  Because the slices partition the window, the per-request sums
reconcile against measured E2E by construction — the reconciliation the
ring acceptance test (tests/subsystems/) asserts end to end.

`observe()` feeds the ledger into `dnet_request_segment_ms{segment=}` so a
serving window's aggregate attribution is scrapeable;
`critical_path_section()` is the JSON shape `GET /v1/debug/timeline/{rid}`
embeds and loadgen rows carry into the BENCH_SERVE report.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from dnet_tpu_torch.obs.phases import (
    REQUEST_SEGMENTS,
    SEG_ADMISSION_WAIT,
    SEG_DECODE_COMPUTE,
    SEG_HOP_RTT,
    SEG_OTHER,
    SEG_PREFILL_COMPUTE,
    SEG_SAMPLE,
    SEG_SCHED_QUEUE,
    SEG_SHARD_COMPUTE,
    SEG_SSE_FLUSH,
    SEG_WIRE_ENCODE,
    SEG_WIRE_TX,
)

# span name -> (segment, specificity).  Higher specificity wins an
# overlapping slice.  Tier 1 is the driver's per-token umbrella, tier 2
# the cross-node round trip it contains, tier 3 the per-node compute
# windows inside THAT, tier 4 leaf work and explicit waits.  Summary /
# marker spans (`request`, `ttft`, zero-duration breadcrumbs) are absent
# on purpose: they describe the window, they do not occupy it.
SPAN_SEGMENTS: Dict[str, Tuple[str, int]] = {
    "decode_step": (SEG_DECODE_COMPUTE, 1),
    "decode_sync_drain": (SEG_DECODE_COMPUTE, 3),
    "hop_rtt": (SEG_HOP_RTT, 2),
    "token_rpc": (SEG_HOP_RTT, 4),
    "prefill": (SEG_PREFILL_COMPUTE, 3),
    "prefix_refill": (SEG_PREFILL_COMPUTE, 3),
    "shard_compute": (SEG_SHARD_COMPUTE, 3),
    # batched decode sub-phases (core/batch.py, obs/phases.py STEP_PHASES):
    # compute-side leaf work; on a shard node they re-map to shard_compute
    # (see _segment_for) so the local-engine and ring stories agree
    "kv_gather": (SEG_DECODE_COMPUTE, 4),
    "compute": (SEG_DECODE_COMPUTE, 4),
    "kv_scatter": (SEG_DECODE_COMPUTE, 4),
    "sample": (SEG_SAMPLE, 4),
    "wire_encode": (SEG_WIRE_ENCODE, 4),
    # tx-stage leg rides under the egress wire_encode umbrella; tier 3 so
    # the encode leaf wins slices they share and only residual stage time
    # (executor queueing) attributes as wire_encode here
    "wire_tx_stage": (SEG_WIRE_ENCODE, 3),
    "transport_send": (SEG_WIRE_TX, 4),
    "shard_tx": (SEG_WIRE_TX, 4),
    "backpressure_pause": (SEG_WIRE_TX, 4),
    "admission_wait": (SEG_ADMISSION_WAIT, 4),
    "lane_queue_wait": (SEG_SCHED_QUEUE, 4),
    "sched_queue": (SEG_SCHED_QUEUE, 4),
    "shard_dequeue": (SEG_SCHED_QUEUE, 4),
    "sse_flush": (SEG_SSE_FLUSH, 4),
}


def _segment_for(span: dict) -> Optional[Tuple[str, int]]:
    mapped = SPAN_SEGMENTS.get(span.get("name", ""))
    if mapped is None:
        return None
    segment, prio = mapped
    # a stitched timeline tags every span with its node; generic compute
    # sub-phases recorded on a shard are that shard's compute, not the
    # API driver's
    node = span.get("node", "")
    if node and node != "api" and segment == SEG_DECODE_COMPUTE:
        segment = SEG_SHARD_COMPUTE
    return segment, prio


def decompose(timeline: Optional[dict]) -> Optional[dict]:
    """Segment ledger for one timeline (local or cluster-stitched), or
    None when there is nothing to attribute.

    Returns ``{"segments_ms", "total_ms", "e2e_ms", "coverage",
    "dominant", "cluster", "spans_attributed"}`` where ``segments_ms``
    carries every REQUEST_SEGMENTS key (zeros included), ``total_ms`` is
    the attribution window (== sum of the segments, by construction) and
    ``e2e_ms`` the closing `request` span's measured duration when one was
    recorded (else the window itself).
    """
    if not timeline:
        return None
    spans = timeline.get("spans") or []
    e2e_ms = None
    window_end = 0.0
    intervals = []  # (start, end, prio, segment)
    for span in spans:
        name = span.get("name", "")
        t0 = float(span.get("t_ms", 0.0))
        dur = float(span.get("dur_ms", 0.0))
        if name == "request":
            e2e_ms = dur
            window_end = max(window_end, t0 + dur)
            continue
        mapped = _segment_for(span)
        if mapped is None or dur <= 0.0:
            continue
        segment, prio = mapped
        intervals.append((t0, t0 + dur, prio, segment))
        window_end = max(window_end, t0 + dur)
    if not intervals and e2e_ms is None:
        return None
    window_start = min([iv[0] for iv in intervals] + [0.0])
    # clip to the window (a stitched remote span mis-corrected past the
    # end must not inflate the ledger)
    events = []  # (pos, +1/-1, interval index)
    for idx, (s, e, _prio, _seg) in enumerate(intervals):
        s = max(s, window_start)
        e = min(e, window_end)
        if e <= s:
            continue
        events.append((s, 1, idx))
        events.append((e, -1, idx))
    events.sort(key=lambda ev: (ev[0], -ev[1]))
    segments = {seg: 0.0 for seg in REQUEST_SEGMENTS}
    active: Dict[int, Tuple[int, str]] = {}
    pos = window_start
    i = 0
    while i < len(events):
        at = events[i][0]
        if at > pos:
            if active:
                # most specific active span claims the slice; ties go to
                # the latest-opened (innermost) interval
                best = max(active.items(), key=lambda kv: (kv[1][0], kv[0]))
                seg = best[1][1]
            else:
                seg = SEG_OTHER
            segments[seg] += at - pos
            pos = at
        while i < len(events) and events[i][0] == at:
            _at, kind, idx = events[i]
            if kind > 0:
                active[idx] = (intervals[idx][2], intervals[idx][3])
            else:
                active.pop(idx, None)
            i += 1
    if window_end > pos:
        segments[SEG_OTHER] += window_end - pos
    total = window_end - window_start
    segments = {seg: round(ms, 3) for seg, ms in segments.items()}
    measured = e2e_ms if e2e_ms is not None else total
    dominant = max(segments, key=lambda seg: segments[seg]) if total else SEG_OTHER
    return {
        "segments_ms": segments,
        "total_ms": round(total, 3),
        "e2e_ms": round(measured, 3),
        "coverage": round(total / measured, 4) if measured > 0 else None,
        "dominant": dominant,
        "cluster": bool(timeline.get("cluster")),
        "spans_attributed": len(intervals),
    }


def observe(ledger: Optional[dict]) -> None:
    """Feed one request's ledger into dnet_request_segment_ms{segment=}."""
    if not ledger:
        return
    from dnet_tpu_torch.obs import metric

    fam = metric("dnet_request_segment_ms")
    for segment, ms in ledger["segments_ms"].items():
        if ms > 0.0:
            fam.labels(segment=segment).observe(ms)


def critical_path_section(timeline: Optional[dict]) -> Optional[dict]:
    """The `critical_path` block debug/timeline and loadgen rows embed."""
    return decompose(timeline)
