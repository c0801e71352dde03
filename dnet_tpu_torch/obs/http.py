"""Shared aiohttp glue for the obs HTTP surface.

Counterpart of dnet_tpu/obs/http.py.

Both server roles (api/http.py, shard/http.py) expose `GET /metrics` and
`GET /v1/debug/timeline/{rid}`; the exposition body and the timeline lookup
live here so the two cannot drift.  Error-shape wrapping stays with each
server (the API wraps 404s as `{"error": {...}}`, the shard as
`{"status": "error", ...}` — each matching its own route convention).
"""

from __future__ import annotations

import time
from typing import Optional

from aiohttp import web

from dnet_tpu_torch.obs import (
    CONTENT_TYPE_LATEST,
    get_recorder,
    get_registry,
    get_slo_tracker,
)


async def metrics_response(request: web.Request) -> web.Response:
    """Prometheus text exposition of this process's registry.  SLO gauges
    refresh lazily here: their values are windowed aggregates, so the
    scrape instant — not the last record_*() call — is when they must be
    current.  Device-memory gauges refresh the same way (they snapshot the
    backend's live allocator, not an event stream)."""
    from dnet_tpu_torch.obs.jit import update_device_mem_gauges

    get_slo_tracker().snapshot()
    update_device_mem_gauges()
    return web.Response(
        body=get_registry().expose().encode("utf-8"),
        headers={"Content-Type": CONTENT_TYPE_LATEST},
    )


def find_timeline(rid: str) -> Optional[dict]:
    """Timeline lookup by public response id.  The recorder keys timelines
    by the internal `chatcmpl-...` nonce; /v1/completions clients hold the
    rewritten `cmpl-...` form (api/inference.py), so that alias is tried
    too — the documented workflow is "rid = the response id", whichever
    endpoint produced it.

    The snapshot carries `t_wall` (this process's wall clock at lookup)
    so a cross-node fetch doubles as an NTP-midpoint clock probe
    (obs/clock.py): the caller brackets the HTTP round trip with its own
    wall clock and estimates this node's offset from the same response
    that delivered the spans."""
    rec = get_recorder()
    timeline = rec.timeline(rid)
    if timeline is None and rid.startswith("cmpl-"):
        timeline = rec.timeline("chat" + rid)
    if timeline is not None:
        timeline["t_wall"] = time.time()
    return timeline
