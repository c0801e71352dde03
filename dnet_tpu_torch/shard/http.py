"""Shard control-plane HTTP server (aiohttp).

Counterpart of dnet_tpu/shard/http.py, trimmed to /load_model,
/update_topology (a delta reload's cheap half: the new epoch and next hop
for a shard whose weights stay; 409 when it cannot prove it holds the
model and layers asked for, and the API then loads it in full),
/unload_model, /profile (this shard's device microbenchmarks,
parallel/profiler.py), /measure_latency (median gRPC echo times to peers),
/health (with the armed chaos spec, if any), the observability routes (/metrics, this
process's Prometheus exposition; /v1/debug/timeline/{rid}, its spans of
one request; /v1/debug/events, its wide-event ring, stamped with `t_wall`
so that the API's fetch doubles as a clock probe) and /cleanup_repacked
(which deletes the weight-
streaming repack cache: the loaded model's subtree, or the whole cache
when none is loaded; 409 while a streaming engine reads it).  `ShardLoadModelRequest` keeps every field of
the reference's, so an API node of either package can load this shard;
the options this slice does not serve answer 422 (shard/compute.py).
/health carries the kernels' launch counts in this process, the hop
codec's frame and byte counts, and the engine's weight plan (and, when it
streams, `engine.weight_cache`: loads, hits, evictions and bytes), the
shard's rounds, its prefix snapshots' counters (`prefix_cache`: hits,
misses, stores, entries) and, when it speculates, `spec` (verify blocks
widened, verified and the tokens they emitted); under
the wire pipeline `wire_pipeline` (the encode ring's depth, slots in
flight and peak, the overlap books), with lanes `lanes` (slots, active).
"""

from __future__ import annotations

import asyncio
import json
import shutil
import time
from pathlib import Path
from typing import List, Optional

from aiohttp import web
from pydantic import BaseModel, Field, ValidationError

from dnet_tpu_torch.config import shard_settings
from dnet_tpu_torch.kernels import launch_counts
from dnet_tpu_torch.obs.events import get_event_ring
from dnet_tpu_torch.obs.clock import ClockSync
from dnet_tpu_torch.obs.http import find_timeline, metrics_response
from dnet_tpu_torch.resilience.chaos import armed_summary
from dnet_tpu_torch.shard.compute import ShardCapabilityError
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


class NextNode(BaseModel):
    host: str
    grpc_port: int


class ShardLoadModelRequest(BaseModel):
    """The reference's load body, field for field (dnet_tpu/shard/http.py)."""

    model_path: str
    layers: List[int]
    next_node: Optional[NextNode] = None
    window_size: int = 0
    residency_size: int = 0
    kv_bits: int = 0
    max_seq_len: int = 4096
    api_callback_address: str = ""
    param_dtype: str = "bfloat16"
    wire_dtype: str = "bfloat16"
    # hop codec of this shard's outgoing hidden frames ("lossless" |
    # "qsparse8"; "" = the shard's own DNET_WIRE_CODEC default)
    wire_codec: str = ""
    weight_quant_bits: int = 0
    mesh_tp: int = 0
    mesh_sp: int = 0
    tp_degree: int = 0
    spec_lookahead: int = 0
    lanes: int = 0
    prefix_cache: int = 0
    epoch: int = 0


class UpdateTopologyRequest(BaseModel):
    """A delta reload's body (the reference's): the shard checks that it
    holds `model_path` and `layers`, then takes `epoch` and `next_node`."""

    model_path: str
    layers: List[int]
    epoch: int = 0
    next_node: Optional[NextNode] = None


class MeasureLatencyRequest(BaseModel):
    peers: List[str]  # "host:grpc_port"
    payload_sizes: List[int] = Field(default_factory=lambda: [1024, 65536, 1048576])
    rounds: int = 3


def _error(status: int, message: str) -> web.Response:
    return web.json_response({"status": "error", "message": message}, status=status)


class ShardHTTPServer:
    def __init__(self, shard) -> None:
        self.shard = shard  # the Shard facade (runtime + adapter)
        self.app = web.Application(client_max_size=16 * 1024 * 1024)
        self.app.router.add_get("/health", self.health)
        self.app.router.add_get("/metrics", self.metrics)
        self.app.router.add_get("/v1/debug/timeline/{rid}", self.debug_timeline)
        self.app.router.add_get("/v1/debug/events", self.debug_events)
        self.app.router.add_post("/load_model", self.load_model)
        self.app.router.add_post("/update_topology", self.update_topology)
        self.app.router.add_post("/unload_model", self.unload_model)
        self.app.router.add_post("/profile", self.profile)
        self.app.router.add_post("/measure_latency", self.measure_latency)
        self.app.router.add_post("/cleanup_repacked", self.cleanup_repacked)
        self._runner: Optional[web.AppRunner] = None

    async def start(self, host: str, port: int) -> None:
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        await web.TCPSite(self._runner, host, port).start()
        log.info("shard HTTP listening on %s:%d", host, port)

    async def stop(self) -> None:
        if self._runner:
            await self._runner.cleanup()
            self._runner = None

    async def metrics(self, request: web.Request) -> web.Response:
        return await metrics_response(request)

    async def debug_timeline(self, request: web.Request) -> web.Response:
        rid = request.match_info["rid"]
        timeline = find_timeline(rid)
        if timeline is None:
            return _error(404, f"no recorded timeline for {rid!r}")
        return web.json_response(timeline)

    async def debug_events(self, request: web.Request) -> web.Response:
        try:
            last_s = float(request.query.get("last_s", "") or 0.0)
        except ValueError:
            return _error(400, "last_s must be a number")
        ring = get_event_ring()
        events = ring.query(
            rid=request.query.get("rid", "").strip(),
            name=request.query.get("name", "").strip(),
            last_s=last_s,
        )
        return web.json_response({"events": events, "dropped": ring.dropped, "t_wall": time.time()})

    async def health(self, request: web.Request) -> web.Response:
        rt = self.shard.runtime
        compute = rt.compute
        body = {
            "status": "ok",
            "role": "shard",
            "shard_id": rt.shard_id,
            "model": rt.model_path or None,
            "layers": [],
            "queue_depth": rt.queue_depth,
            "epoch": rt.epoch,
            "device": str(rt.device),
            "kernels": launch_counts(),
            "compute": dict(rt.compute_stats),
        }
        chaos = armed_summary()
        if chaos is not None:
            # an injected fault must never pass for a real one
            body["chaos"] = chaos
        if compute is not None:
            # layers, rounds, sessions, the prefix snapshots' counters and
            # the verify blocks
            body.update(compute.health())
            body["wire_codec"] = compute.wire_codec
            body["wire"] = dict(compute.wire_stats)
            body.update(compute.ring_stats())
            # the weights' and the cache's form and bytes on this shard
            body["engine"] = compute.engine.stats()
        return web.json_response(body)

    async def load_model(self, request: web.Request) -> web.Response:
        try:
            req = ShardLoadModelRequest.model_validate(await request.json())
        except (json.JSONDecodeError, ValidationError) as exc:
            return _error(400, f"invalid request: {exc}")
        t0 = time.perf_counter()
        try:
            await self.shard.load_model(req)
        except FileNotFoundError as exc:
            return _error(404, str(exc))
        except ShardCapabilityError as exc:
            return _error(422, str(exc))
        except Exception as exc:
            log.exception("shard load_model failed")
            return _error(500, str(exc))
        return web.json_response({"status": "ok", "load_time_s": time.perf_counter() - t0})

    async def update_topology(self, request: web.Request) -> web.Response:
        try:
            req = UpdateTopologyRequest.model_validate(await request.json())
        except (json.JSONDecodeError, ValidationError) as exc:
            return _error(400, f"invalid request: {exc}")
        try:
            await self.shard.update_topology(req)
        except ValueError as exc:
            # holds nothing, another model or other layers: refuse, and the
            # API loads this shard in full
            return _error(409, str(exc))
        except Exception as exc:
            log.exception("shard update_topology failed")
            return _error(500, str(exc))
        return web.json_response({"status": "ok", "epoch": self.shard.runtime.epoch})

    async def unload_model(self, request: web.Request) -> web.Response:
        await self.shard.unload_model()
        return web.json_response({"status": "ok"})

    async def profile(self, request: web.Request) -> web.Response:
        """This shard's device profile, measured in this process off the
        event loop (parallel/profiler.py); a failed probe answers 500."""
        from dnet_tpu_torch.parallel.profiler import profile_device

        try:
            result = await asyncio.get_running_loop().run_in_executor(
                None, profile_device, self.shard.runtime.device
            )
        except Exception as exc:
            log.exception("device profile failed")
            return _error(500, f"profile failed: {exc}")
        return web.json_response({"status": "ok", "profile": result})

    async def measure_latency(self, request: web.Request) -> web.Response:
        """Echo each peer over gRPC at each payload size; the median round
        trip (s) per (peer, size), and the clock offsets the same probes
        give."""
        try:
            req = MeasureLatencyRequest.model_validate(await request.json())
        except (json.JSONDecodeError, ValidationError) as exc:
            return _error(400, f"invalid request: {exc}")
        from dnet_tpu_torch.transport.grpc_transport import RingClient
        from dnet_tpu_torch.transport.protocol import LatencyProbe

        results = {}
        clocks = ClockSync()
        for peer in req.peers:
            client = RingClient(peer)
            per_size = {}
            try:
                for size in req.payload_sizes:
                    rtts = []
                    payload = b"\x00" * size
                    for _ in range(req.rounds):
                        t0, t0_wall = time.perf_counter(), time.time()
                        try:
                            echo = await client.measure_latency(LatencyProbe(t_sent=t0_wall, payload=payload))
                        except Exception as exc:
                            log.warning("latency probe to %s failed: %s", peer, exc)
                            continue
                        rtts.append(time.perf_counter() - t0)
                        if echo.t_remote:
                            clocks.update(peer, t0_wall, echo.t_remote, time.time())
                    if rtts:
                        per_size[str(size)] = sorted(rtts)[len(rtts) // 2]
            finally:
                await client.close()
            results[peer] = per_size
        offsets = {
            peer: {"offset_s": est.offset_s, "rtt_s": est.rtt_s}
            for peer in req.peers
            if (est := clocks.estimate(peer)) is not None
        }
        return web.json_response({"status": "ok", "latency": results, "clock_offsets": offsets})

    async def cleanup_repacked(self, request: web.Request) -> web.Response:
        """Delete the repack cache: the loaded model's subtree, else the
        whole directory; refused (409) while a streaming engine reads it."""
        rt = self.shard.runtime

        def cleanup():
            # under the model lock: no load is half-way while we look
            with rt._model_lock:
                compute = rt.compute
                if compute is not None and compute.engine.plan.streams_weights:
                    return None, 0
                target = Path(shard_settings().repack_dir).expanduser()
                if rt.model_path:
                    target = target / Path(rt.model_path).name
                freed = 0
                if target.is_dir():
                    freed = sum(f.stat().st_size for f in target.rglob("*") if f.is_file())
                    shutil.rmtree(target, ignore_errors=True)
                return str(target), freed

        removed, freed = await asyncio.get_running_loop().run_in_executor(None, cleanup)
        if removed is None:
            return _error(409, "model is streaming from the repack cache; POST /unload_model first")
        return web.json_response({"status": "ok", "removed": removed, "freed_bytes": freed})
