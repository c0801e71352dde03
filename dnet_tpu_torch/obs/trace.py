"""Chrome trace-event / Perfetto JSON export of flight-recorder timelines.

Counterpart of dnet_tpu/obs/trace.py.  The overlapped wire pipeline is not
ported (shards refuse it), so every hop-codec millisecond is paid on the
compute thread: `otherData.wire_overlap` reports the codec histograms'
sums as serial time and an overlap ratio of 0.

Everything the debug surface already records — per-request spans (local or
cluster-stitched, obs/recorder.py + obs/clock.py), scheduler tick records
(sched/flight.py), and the wire-overlap books — renders as one trace-event JSON object that chrome://tracing and
ui.perfetto.dev open directly:

- one PROCESS track per node (`api`, shard instance ids), each with
  `driver` / `compute` / `tx-stage` THREAD tracks so compute work and
  wire work stack on separate lanes,
- `X` complete events for timed spans, `i` instants for zero-duration
  markers (prefix_cache_hit, deadline_drop, transport_recv),
- `s`/`f` FLOW events (cat `wire`, id `rid/seq`) stitching a request's
  frames across hops: each tx span on one node arrows to the matching
  `transport_recv` on the next,
- `C` counter tracks from the tick flight-recorder: queue depths by
  scheduler state and KV block-pool occupancy over time.

Timestamps are microseconds (the trace-event unit) relative to the
earliest timeline origin, so multi-node dumps line up on the stitched
clock.  Event count is capped (DNET_OBS_TRACE_MAX_EVENTS); a truncated
dump says so in `otherData` instead of silently looking complete.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

# ---- track taxonomy ---------------------------------------------------
# thread ids within each node's process track; DL028 cross-checks these
# labels against the span routing below
TID_DRIVER = 1
TID_COMPUTE = 2
TID_TX = 3

TRACE_THREADS = {
    TID_DRIVER: "driver",
    TID_COMPUTE: "compute",
    TID_TX: "tx-stage",
}

#: span names that render on the compute thread track
COMPUTE_SPANS = frozenset({
    "prefill",
    "prefix_refill",
    "decode_sync_drain",
    "shard_compute",
    "kv_gather",
    "compute",
    "kv_scatter",
    "sample",
})

#: span names that render on the tx-stage thread track
TX_SPANS = frozenset({
    "wire_encode",
    "wire_tx_stage",
    "shard_tx",
    "transport_send",
    "transport_recv",
    "backpressure_pause",
    "token_rpc",
})

#: tx-side span names that OPEN a cross-hop flow arrow (paired with the
#: receiving node's transport_recv carrying the same seq)
FLOW_TX_SPANS = frozenset({"shard_tx", "transport_send"})
FLOW_RX_SPAN = "transport_recv"

_SPAN_CORE_KEYS = ("name", "t_ms", "dur_ms", "node")


def _tid_for(name: str) -> int:
    if name in COMPUTE_SPANS:
        return TID_COMPUTE
    if name in TX_SPANS:
        return TID_TX
    return TID_DRIVER


def _span_args(span: dict, rid: str) -> dict:
    # recorder spans nest their kwargs under "meta"; stitched spans add
    # top-level keys (node) — flatten both into the event args
    args = {
        k: v
        for k, v in span.items()
        if k not in _SPAN_CORE_KEYS and k != "meta"
    }
    args.update(span.get("meta") or {})
    args["rid"] = rid
    return args


def _wire_overlap() -> dict:
    """The reference's overlap books, from the codec histograms: with no
    wire pipeline nothing is hidden off the compute thread."""
    from dnet_tpu_torch.obs import metric

    serial = metric("dnet_wire_encode_ms").sum + metric("dnet_wire_decode_ms").sum
    return {"serial_ms": serial, "hidden_ms": 0.0, "stall_ms": 0.0, "ratio": 0.0}


def export_trace(
    timelines: Iterable[dict],
    tick_records: Optional[List[dict]] = None,
    max_events: Optional[int] = None,
    wide_events: Optional[List[dict]] = None,
) -> dict:
    """Render timelines (+ optional tick records) as trace-event JSON.

    `timelines` are `FlightRecorder.timeline()` dicts or cluster-stitched
    `stitch_timelines()` dicts — the only difference is that stitched
    spans carry a `node` key; bare spans land on the `api` process.
    `tick_records` are `TickRecord.as_dict()` rows and become counter
    tracks on the api process.  `wide_events` are obs/events.py journal
    rows (absolute `t_unix`, optional `node`) and render as `i` instants
    (cat `event`) on the owning node's driver track — a `preempted`
    marker lands visually inside the decode gap it caused."""
    timelines = [tl for tl in timelines if tl]
    tick_records = list(tick_records or [])
    wide_events = list(wide_events or [])
    if max_events is None:
        from dnet_tpu_torch.config import obs_settings

        max_events = obs_settings().trace_max_events

    # base: earliest origin across everything that carries a wall time,
    # so every ts is a small non-negative microsecond offset
    origins = [float(tl["t_unix"]) for tl in timelines]
    origins += [float(r["t_unix"]) for r in tick_records if "t_unix" in r]
    origins += [float(e["t_unix"]) for e in wide_events if "t_unix" in e]
    base = min(origins) if origins else 0.0

    # pid per node: api is always 1; shard nodes take stable sorted slots
    nodes = {"api"}
    for tl in timelines:
        for span in tl["spans"]:
            nodes.add(span.get("node") or "api")
    for e in wide_events:
        nodes.add(e.get("node") or "api")
    pids = {"api": 1}
    for i, node in enumerate(sorted(nodes - {"api"}), start=2):
        pids[node] = i

    meta_events: List[dict] = []
    for node, pid in sorted(pids.items(), key=lambda kv: kv[1]):
        meta_events.append({
            "ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": node},
        })
        meta_events.append({
            "ph": "M", "pid": pid, "name": "process_sort_index",
            "args": {"sort_index": pid},
        })
        for tid, tname in TRACE_THREADS.items():
            meta_events.append({
                "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                "args": {"name": tname},
            })

    events: List[dict] = []
    # (rid, seq) -> [endpoints] for flow stitching.  A frame keeps its
    # seq across every hop of the ring, so one key can hold several
    # tx/rx pairs (api->shard-0, shard-0->shard-1, ...); each tx is
    # matched below to the EARLIEST unclaimed recv that happens after
    # it, which orients the arrows even when every span sits in one
    # process-wide timeline (the in-process ring has no node tags).
    flow_tx: dict = {}
    flow_rx: dict = {}
    for tl in timelines:
        rid = tl.get("rid", "")
        tl_base_us = (float(tl["t_unix"]) - base) * 1e6
        for span in tl["spans"]:
            node = span.get("node") or "api"
            pid = pids[node]
            tid = _tid_for(span["name"])
            ts = tl_base_us + float(span["t_ms"]) * 1000.0
            dur = float(span["dur_ms"]) * 1000.0
            args = _span_args(span, rid)
            if dur > 0.0:
                events.append({
                    "name": span["name"], "cat": "span", "ph": "X",
                    "ts": ts, "dur": dur, "pid": pid, "tid": tid,
                    "args": args,
                })
            else:
                events.append({
                    "name": span["name"], "cat": "span", "ph": "i",
                    "ts": ts, "s": "t", "pid": pid, "tid": tid,
                    "args": args,
                })
            seq = span.get("seq", (span.get("meta") or {}).get("seq"))
            if seq is not None:
                key = (rid, seq)
                if span["name"] in FLOW_TX_SPANS:
                    # arrow leaves with the frame: at tx-span start
                    flow_tx.setdefault(key, []).append((ts, pid, tid))
                elif span["name"] == FLOW_RX_SPAN:
                    flow_rx.setdefault(key, []).append((ts, pid, tid))

    for key in sorted(flow_tx.keys() & flow_rx.keys(), key=str):
        rid, seq = key
        txs = sorted(flow_tx[key])
        rxs = sorted(flow_rx[key])
        hop = 0
        for tx_ts, tx_pid, tx_tid in txs:
            rx = next((r for r in rxs if r[0] >= tx_ts), None)
            if rx is None:
                continue
            rxs.remove(rx)
            rx_ts, rx_pid, rx_tid = rx
            flow_id = f"{rid}/{seq}/{hop}"
            hop += 1
            events.append({
                "name": "wire", "cat": "wire", "ph": "s", "id": flow_id,
                "ts": tx_ts, "pid": tx_pid, "tid": tx_tid,
            })
            events.append({
                "name": "wire", "cat": "wire", "ph": "f", "bp": "e",
                "id": flow_id, "ts": rx_ts, "pid": rx_pid, "tid": rx_tid,
            })

    # wide events (obs/events.py): instants on the owning node's driver
    # track, correlated to the surrounding spans by wall time + rid args
    for e in wide_events:
        if "t_unix" not in e:
            continue
        node = e.get("node") or "api"
        args = {k: v for k, v in e.items() if k not in ("name", "t_unix")}
        events.append({
            "name": e["name"], "cat": "event", "ph": "i",
            "ts": (float(e["t_unix"]) - base) * 1e6, "s": "t",
            "pid": pids[node], "tid": TID_DRIVER, "args": args,
        })

    for rec in tick_records:
        if "t_unix" not in rec:
            continue
        ts = (float(rec["t_unix"]) - base) * 1e6
        depths = rec.get("queue_depths") or {}
        if depths:
            events.append({
                "name": "sched queue depth", "cat": "sched", "ph": "C",
                "ts": ts, "pid": pids["api"],
                "args": {k: int(v) for k, v in depths.items()},
            })
        events.append({
            "name": "kv blocks", "cat": "sched", "ph": "C", "ts": ts,
            "pid": pids["api"],
            "args": {
                "used": int(rec.get("kv_blocks_used", 0)),
                "free": int(rec.get("kv_blocks_free", 0)),
            },
        })

    events.sort(key=lambda e: e["ts"])
    truncated = 0
    if len(events) > max_events:
        truncated = len(events) - max_events
        events = events[:max_events]

    out = {
        "traceEvents": meta_events + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "base_unix_s": base,
            "timelines": len(timelines),
            "tick_records": len(tick_records),
            "wide_events": len(wide_events),
            "wire_overlap": _wire_overlap(),
        },
    }
    if truncated:
        out["otherData"]["truncated_events"] = truncated
    return out
