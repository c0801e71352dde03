"""API-node HTTP server (aiohttp): the OpenAI-compatible routes and the
observability surface.

Counterpart of dnet_tpu/api/http.py, trimmed to
  POST /v1/chat/completions  SSE streaming + aggregate
  POST /v1/completions       legacy text completions
  POST /v1/embeddings        mean-pooled final hidden states (the ring: 501)
  GET  /v1/models            the catalog with its quant variants, and the
                             loaded model
  POST /v1/load_model        load a local checkpoint (in ring mode: the
                             fan-out to the shards)
  POST /v1/unload_model      drop the model and free its device memory
  POST /v1/prepare_topology  ring mode: profile the shards and solve the
                             layer split (parallel/solver.py)
  POST /v1/prepare_topology_manual
                             ring mode: assign layer ranges to shards
  GET  /v1/topology          the installed topology and its epoch
  GET  /v1/devices           the shards discovery knows
  GET  /health               + admission, the rolling SLO windows, and in
                             ring mode the epoch, the shards' health and
                             the quarantine ("degraded" while a shard is
                             down or an SLO burns, "draining" on shutdown)
  GET  /metrics              Prometheus text exposition (obs/)
  GET  /v1/cluster/metrics   every shard's /metrics and this node's, merged
                             with node labels (ring mode)
  GET  /v1/debug/timeline/{rid}
                             one request's flight-recorder spans and its
                             critical-path ledger (?cluster=1 stitches the
                             shards' spans in on this node's clock)
  GET  /v1/debug/trace/{rid} one request as Chrome trace / Perfetto JSON
  GET  /v1/debug/trace       the serving window (?last_s=N) as one trace
  GET  /v1/debug/events      the wide-event ring (?rid= ?name= ?last_s=;
                             ?cluster=1 merges the shards')
  GET  /v1/debug/sched       the scheduler's tick flight ring (?last=N)
with the reference's serialization, so the same request gets the same
bytes back (SSE: `data: <json>\\n\\n` frames, then `data: [DONE]`).
"""

from __future__ import annotations

import asyncio
import inspect
import json
import time
from typing import Optional

import aiohttp

from aiohttp import web
from pydantic import ValidationError

from dnet_tpu_torch.admission.controller import AdmissionRejected
from dnet_tpu_torch.api.inference import (
    BackpressureError,
    DeadlineExceededError,
    EngineCapabilityError,
    InferenceError,
    InferenceManager,
    PromptTooLongError,
    ServiceDegradedError,
    completion_logprobs,
)
from dnet_tpu_torch.api.catalog import expanded_catalog, split_variant
from dnet_tpu_torch.api.model_manager import resolve_model_dir, weight_quant
from dnet_tpu_torch.api.ring_manager import build_manual_topology
from dnet_tpu_torch.api.schemas import (
    ChatCompletionRequest,
    CompletionRequest,
    EmbeddingsRequest,
    HealthResponse,
    LoadModelRequest,
    LoadModelResponse,
    ModelInfo,
    ModelList,
    PrepareTopologyManualRequest,
    PrepareTopologyRequest,
    UnloadModelResponse,
)
from dnet_tpu_torch.config import api_settings, obs_settings
from dnet_tpu_torch.obs import CONTENT_TYPE_LATEST, get_recorder, get_registry, get_slo_tracker, metric
from dnet_tpu_torch.obs.clock import offset_from_probe, stitch_timelines
from dnet_tpu_torch.obs.critical_path import critical_path_section
from dnet_tpu_torch.obs.events import get_event_ring, merge_remote_events
from dnet_tpu_torch.obs.federation import federate
from dnet_tpu_torch.obs.http import find_timeline, metrics_response
from dnet_tpu_torch.obs.phases import EVENT_NAMES
from dnet_tpu_torch.obs.trace import export_trace
from dnet_tpu_torch.resilience.chaos import armed_summary
from dnet_tpu_torch.sched.flight import get_tick_recorder
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


_TRUE = ("1", "true", "yes", "on")


def _json_error(
    status: int, message: str, err_type: str = "invalid_request_error",
    retry_after_s: Optional[float] = None,
):
    headers = None
    if retry_after_s is not None:
        # Retry-After is integral seconds per RFC 9110; never 0
        headers = {"Retry-After": str(max(1, round(retry_after_s)))}
    return web.json_response(
        {"error": {"message": message, "type": err_type}}, status=status, headers=headers
    )


def _topology_json(topo, solution: bool = False) -> dict:
    """A topology as the reference's routes render it: the manual route
    without the streaming fields and the solution, the solved route and
    GET /v1/topology with both."""
    assignments = []
    for a in topo.assignments:
        row = {"instance": a.instance, "layers": a.layers, "next_instance": a.next_instance}
        if solution:
            row.update(window_size=a.window_size, residency_size=a.residency_size)
        row.update(mesh_tp=a.mesh_tp, mesh_sp=a.mesh_sp)
        assignments.append(row)
    body = {"model": topo.model, "num_layers": topo.num_layers, "epoch": topo.epoch}
    if solution:
        body["solution"] = topo.solution
    body["assignments"] = assignments
    return body


class ApiHTTPServer:
    def __init__(self, inference: InferenceManager, model_manager, cluster_manager=None) -> None:
        self.inference = inference
        self.model_manager = model_manager
        self.cluster_manager = cluster_manager  # ring mode only
        self.app = web.Application(client_max_size=64 * 1024 * 1024)
        self.app.router.add_post("/v1/chat/completions", self.chat_completions)
        self.app.router.add_post("/v1/completions", self.completions)
        self.app.router.add_post("/v1/embeddings", self.embeddings)
        self.app.router.add_get("/v1/models", self.list_models)
        self.app.router.add_post("/v1/load_model", self.load_model)
        self.app.router.add_post("/v1/unload_model", self.unload_model)
        self.app.router.add_post("/v1/prepare_topology", self.prepare_topology)
        self.app.router.add_post("/v1/prepare_topology_manual", self.prepare_topology_manual)
        self.app.router.add_get("/v1/topology", self.get_topology)
        self.app.router.add_get("/v1/devices", self.get_devices)
        self.app.router.add_get("/health", self.health)
        self.app.router.add_get("/metrics", self.metrics)
        self.app.router.add_get("/v1/cluster/metrics", self.cluster_metrics)
        self.app.router.add_get("/v1/debug/timeline/{rid}", self.debug_timeline)
        self.app.router.add_get("/v1/debug/sched", self.debug_sched)
        self.app.router.add_get("/v1/debug/trace", self.debug_trace_window)
        self.app.router.add_get("/v1/debug/trace/{rid}", self.debug_trace)
        self.app.router.add_get("/v1/debug/events", self.debug_events)
        self._runner: Optional[web.AppRunner] = None
        # peers of earlier /v1/cluster/metrics scrapes: one that leaves
        # discovery drops to scrape_ok 0 instead of freezing at 1
        self._scraped_peers: set = set()

    async def start(self, host: str, port: int) -> None:
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        await web.TCPSite(self._runner, host, port).start()
        log.info("API HTTP listening on %s:%d", host, port)

    async def stop(self) -> None:
        if self._runner:
            await self._runner.cleanup()
            self._runner = None

    def _gate(self):
        admission = self.inference.admission
        if admission.draining:
            # drain window: in-flight streams finish, new work is told when
            # to come back
            return _json_error(503, "server is draining for shutdown", "service_unavailable",
                               retry_after_s=admission.retry_after_s())
        if not self.inference.ready:
            return _json_error(400, "no model loaded; POST /v1/load_model first")
        monitor = self.inference.failure_monitor
        if monitor is not None and monitor.degraded:
            return _json_error(503, f"ring degraded: shard(s) {monitor.down_shards()} down", "service_unavailable")
        return None

    def _map_inference_errors(self, exc: Exception):
        if isinstance(exc, AdmissionRejected):
            status = 503 if exc.reason == "draining" else 429
            return _json_error(status, str(exc),
                               "service_unavailable" if status == 503 else "rate_limit_exceeded",
                               retry_after_s=exc.retry_after_s)
        if isinstance(exc, BackpressureError):
            return _json_error(429, str(exc), "rate_limit_exceeded",
                               retry_after_s=self.inference.admission.retry_after_s())
        if isinstance(exc, DeadlineExceededError):
            return _json_error(504, str(exc), "deadline_exceeded")
        if isinstance(exc, PromptTooLongError):
            return _json_error(400, str(exc))
        if isinstance(exc, EngineCapabilityError):
            # the serving config asked the engine for something it cannot do
            return _json_error(422, str(exc), "invalid_request_error")
        if isinstance(exc, ServiceDegradedError):
            return _json_error(503, str(exc), "service_unavailable")
        if isinstance(exc, ConnectionError):
            # a transport failure before any chunk: retryable unavailability
            return _json_error(503, str(exc), "service_unavailable")
        if isinstance(exc, InferenceError):
            return _json_error(500, str(exc), "server_error")
        raise exc

    async def _sse(self, request, req, reshape) -> web.StreamResponse:
        """Stream the decode chunks as SSE; `reshape(chunk) -> [json str]`.
        The first chunk is awaited before the 200 is committed, so a request
        refused before its first token keeps its real status code."""
        gen = self.inference.generate_stream(req)
        try:
            try:
                first = await gen.__anext__()
            except StopAsyncIteration:
                first = None
            except Exception as exc:
                return self._map_inference_errors(exc)
            resp = web.StreamResponse(
                status=200,
                headers={
                    "Content-Type": "text/event-stream",
                    "Cache-Control": "no-cache",
                    "Connection": "keep-alive",
                },
            )
            await resp.prepare(request)

            async def write_chunk(chunk) -> None:
                # serialize + flush, timed as the request's sse_flush segment
                t_w = time.perf_counter()
                for payload in reshape(chunk):
                    await resp.write(f"data: {payload}\n\n".encode())
                get_recorder().span(chunk.id, "sse_flush", (time.perf_counter() - t_w) * 1000.0)

            try:
                if first is not None:
                    await write_chunk(first)
                    async for chunk in gen:
                        await write_chunk(chunk)
                await resp.write(b"data: [DONE]\n\n")
            except PromptTooLongError as exc:
                err = json.dumps({"error": {"message": str(exc), "type": "invalid_request_error"}})
                await resp.write(f"data: {err}\n\n".encode())
            except DeadlineExceededError as exc:
                err = json.dumps({"error": {"message": str(exc), "type": "deadline_exceeded"}})
                await resp.write(f"data: {err}\n\n".encode())
            except BackpressureError as exc:
                # capacity shed mid-stream is not a server fault
                err = json.dumps({"error": {"message": str(exc), "type": "rate_limit_exceeded"}})
                await resp.write(f"data: {err}\n\n".encode())
            except InferenceError as exc:
                err = json.dumps({"error": {"message": str(exc), "type": "server_error"}})
                await resp.write(f"data: {err}\n\n".encode())
            except ConnectionResetError:
                log.info("client disconnected mid-stream")
            await resp.write_eof()
            return resp
        finally:
            # closing an abandoned generator frees the request's KV
            await gen.aclose()

    async def chat_completions(self, request: web.Request) -> web.StreamResponse:
        try:
            req = ChatCompletionRequest.model_validate(await request.json())
        except (json.JSONDecodeError, ValidationError) as exc:
            return _json_error(400, f"invalid request: {exc}")
        gate = self._gate()
        if gate is not None:
            return gate
        if req.stream:
            return await self._sse(request, req, lambda c: [c.model_dump_json(exclude_none=True)])
        try:
            result = await self.inference.generate(req)
        except Exception as exc:
            return self._map_inference_errors(exc)
        return web.json_response(result.model_dump(exclude_none=True))

    async def completions(self, request: web.Request) -> web.StreamResponse:
        """Legacy /v1/completions: raw prompt, text_completion objects."""
        try:
            req = CompletionRequest.model_validate(await request.json())
        except (json.JSONDecodeError, ValidationError) as exc:
            return _json_error(400, f"invalid request: {exc}")
        gate = self._gate()
        if gate is not None:
            return gate
        if req.stream:
            state = {"first": True, "offset": len(req.prompt_text()) if req.echo else 0}

            def reshape(chunk):
                """Chat-style deltas -> completion chunks (echo emits the
                prompt before the first delta)."""
                out = {
                    "id": chunk.id.replace("chatcmpl", "cmpl"),
                    "object": "text_completion",
                    "model": req.model,
                    "choices": [],
                }
                for c in chunk.choices:
                    text = c.delta.content or ""
                    if state["first"] and (text or c.finish_reason):
                        state["first"] = False
                        if req.echo:
                            text = req.prompt_text() + text
                    choice = {"index": 0, "text": text, "finish_reason": c.finish_reason}
                    if c.logprobs is not None:
                        lp = completion_logprobs(c.logprobs.content, state["offset"])
                        state["offset"] += sum(len(t) for t in lp.tokens)
                        choice["logprobs"] = lp.model_dump()
                    out["choices"].append(choice)
                if chunk.usage:
                    out["usage"] = chunk.usage.model_dump()
                return [json.dumps(out)]

            return await self._sse(request, req, reshape)
        try:
            result = await self.inference.generate_completion(req)
        except Exception as exc:
            return self._map_inference_errors(exc)
        return web.json_response(result.model_dump(exclude_none=True))

    async def embeddings(self, request: web.Request) -> web.Response:
        """Mean-pooled final hidden states.  The local, batched and mesh
        engines serve them; the ring, whose shards never send hidden states
        back to this node, answers 501."""
        try:
            req = EmbeddingsRequest.model_validate(await request.json())
        except (json.JSONDecodeError, ValidationError) as exc:
            return _json_error(400, f"invalid request: {exc}")
        gate = self._gate()
        if gate is not None:
            return gate
        try:
            result = await self.inference.embeddings(req)
        except NotImplementedError as exc:
            return _json_error(501, str(exc), "not_implemented")
        except ValueError as exc:
            return _json_error(400, str(exc))
        except Exception as exc:
            return self._map_inference_errors(exc)
        return web.json_response(result.model_dump())

    async def list_models(self, request: web.Request) -> web.Response:
        # the catalog's rows, each quant variant its own (`<id>:int8`), and
        # the loaded id where the catalog does not list it
        data = [ModelInfo(id=e.id) for e in expanded_catalog()]
        loaded = self.model_manager.current_model_id
        if loaded and all(m.id != loaded for m in data):
            data.append(ModelInfo(id=loaded))
        return web.json_response(ModelList(data=data).model_dump())

    async def load_model(self, request: web.Request) -> web.Response:
        try:
            req = LoadModelRequest.model_validate(await request.json())
        except (json.JSONDecodeError, ValidationError) as exc:
            return _json_error(400, f"invalid request: {exc}")
        kwargs = {}
        if req.delta:
            # only a manager that fans out to shards takes `delta`
            if "delta" not in inspect.signature(self.model_manager.load_model).parameters:
                return _json_error(400, "delta reload is only available in ring mode")
            kwargs["delta"] = True
        try:
            dt = await self.model_manager.load_model(req.model, max_seq=req.max_seq_len, **kwargs)
        except FileNotFoundError as exc:
            return _json_error(404, str(exc), "model_not_found")
        except EngineCapabilityError as exc:
            # a configuration the port does not serve: 422, nothing half-loaded
            return _json_error(422, str(exc), "invalid_request_error")
        except Exception as exc:
            log.exception("load_model failed")
            return _json_error(500, f"load failed: {exc}", "server_error")
        return web.json_response(LoadModelResponse(model=req.model, load_time_s=dt).model_dump())

    async def unload_model(self, request: web.Request) -> web.Response:
        await self.model_manager.unload_model()
        return web.json_response(UnloadModelResponse(message="unloaded").model_dump())

    async def prepare_topology(self, request: web.Request) -> web.Response:
        """Profile every healthy shard, then solve the layer split over them
        (parallel/solver.py) and install it under a new epoch.  A shard
        whose profile failed stops the solve (502)."""
        if self.cluster_manager is None:
            return _json_error(400, "not in ring mode (start with --hostfile or --discovery udp)")
        try:
            req = PrepareTopologyRequest.model_validate(await request.json())
        except (json.JSONDecodeError, ValidationError) as exc:
            return _json_error(400, f"invalid request: {exc}")
        from dnet_tpu_torch.config import topology_settings
        from dnet_tpu_torch.parallel.solver import model_profile_from_checkpoint, solve_topology

        base_id, wq, _ = weight_quant(req.model, api_settings())
        model_dir = resolve_model_dir(base_id, getattr(self.model_manager, "models_dir", None))
        if model_dir is None:
            return _json_error(404, f"model {req.model!r} not found locally", "model_not_found")
        devices = await self.cluster_manager.profile_cluster()
        if not devices:
            return _json_error(503, "no healthy shards discovered", "no_devices")
        failed = self.cluster_manager.profile_errors
        if failed:
            return _json_error(502, f"device profile failed on {sorted(failed)}: {failed}", "server_error")
        ts = topology_settings()
        try:
            profile = model_profile_from_checkpoint(model_dir, seq_len=req.seq_len, kv_bits=req.kv_bits,
                                                    weight_quant_bits=wq)
            topo = solve_topology(devices, profile, kv_bits=req.kv_bits, solver=ts.solver, mip_gap=ts.mip_gap)
        except ValueError as exc:
            return _json_error(400, str(exc))
        topo.model = req.model
        # install, not assign: the new epoch arms the fence for the load
        self.cluster_manager.install_topology(topo)
        return web.json_response({"status": "ok", "topology": _topology_json(topo, solution=True)})

    async def get_topology(self, request: web.Request) -> web.Response:
        topo = getattr(self.cluster_manager, "current_topology", None)
        if topo is None:
            return web.json_response({"topology": None})
        body = _topology_json(topo, solution=True)
        body["kv_bits"] = topo.kv_bits
        return web.json_response({"topology": body})

    async def get_devices(self, request: web.Request) -> web.Response:
        if self.cluster_manager is None:
            return web.json_response({"devices": []})
        devices = await self.cluster_manager.scan_devices()
        return web.json_response({"devices": [
            {"instance": d.instance, "host": d.host, "http_port": d.http_port, "grpc_port": d.grpc_port,
             "is_manager": d.is_manager, "slice_id": d.slice_id, "chip_count": d.chip_count}
            for d in devices
        ]})

    async def prepare_topology_manual(self, request: web.Request) -> web.Response:
        """Manual layer assignment -> the ring topology (ring mode only)."""
        if self.cluster_manager is None:
            return _json_error(400, "not in ring mode (start with --hostfile or --discovery udp)")
        try:
            req = PrepareTopologyManualRequest.model_validate(await request.json())
        except (json.JSONDecodeError, ValidationError) as exc:
            return _json_error(400, f"invalid request: {exc}")
        # a quant variant's layers are its base checkpoint's
        model_dir = resolve_model_dir(split_variant(req.model)[0], getattr(self.model_manager, "models_dir", None))
        if model_dir is None:
            return _json_error(404, f"model {req.model!r} not found locally", "model_not_found")
        num_layers = json.loads((model_dir / "config.json").read_text())["num_hidden_layers"]
        devices = await self.cluster_manager.healthy_devices()
        try:
            topo = build_manual_topology(
                req.model, num_layers, [a.model_dump() for a in req.assignments], devices,
                kv_bits=req.kv_bits,
            )
        except ValueError as exc:
            return _json_error(400, str(exc))
        self.cluster_manager.install_topology(topo)
        return web.json_response({"status": "ok", "topology": _topology_json(topo)})

    async def health(self, request: web.Request) -> web.Response:
        body = HealthResponse(model=self.model_manager.current_model_id).model_dump()
        chaos = armed_summary()
        if chaos is not None:
            # an injected fault must never pass for a real one
            body["chaos"] = chaos
        if self.cluster_manager is not None:
            body["epoch"] = self.cluster_manager.epoch
        monitor = self.inference.failure_monitor
        if monitor is not None:
            # quarantined shards do not degrade the status: the re-solved
            # ring serves, below full capacity
            body["quarantine"] = monitor.quarantine.snapshot()
            if monitor.health:
                body["shards"] = monitor.snapshot()
                if monitor.degraded:
                    body["status"] = "degraded"
        # a burning SLO degrades /health: slow is its own kind of down
        slo = get_slo_tracker().snapshot()
        body["slo"] = slo
        if slo["burning"]:
            body["status"] = "degraded"
        admission = self.inference.admission
        body["admission"] = {"active": admission.active, "queued": admission.queued,
                             "capacity": admission.capacity}
        if admission.draining:
            # draining wins over degraded: balancers must stop routing here
            body["status"] = "draining"
            body["admission"]["epoch"] = body.get("epoch", 0)
            body["admission"]["quarantine"] = list(body.get("quarantine") or ())
        stats = getattr(getattr(self.model_manager, "engine", None), "stats", None)
        if stats is not None:
            body["engine"] = stats()
        return web.json_response(body)

    async def metrics(self, request: web.Request) -> web.Response:
        """This process's Prometheus exposition (the SLO and device-memory
        gauges refresh at the scrape)."""
        return await metrics_response(request)

    async def _fan_out_shards(self, fetch) -> tuple:
        """`fetch(session, device)` over every discovered shard at once, under
        the obs scrape timeout; returns (devices, the non-None results)."""
        devices = await self.cluster_manager.scan_devices()
        timeout = aiohttp.ClientTimeout(total=obs_settings().cluster_scrape_timeout_s)
        async with aiohttp.ClientSession(timeout=timeout) as session:
            results = await asyncio.gather(*(fetch(session, d) for d in devices))
        return devices, [r for r in results if r is not None]

    async def cluster_metrics(self, request: web.Request) -> web.Response:
        """Every shard's /metrics and this node's, each sample labelled
        `node="<id>"`, merged into one exposition (obs/federation.py).  An
        unreachable shard is skipped and reads dnet_federation_scrape_ok 0."""
        sections: list = []
        if self.cluster_manager is not None:
            scrape_ok = metric("dnet_federation_scrape_ok")

            async def fetch(session, d):
                try:
                    async with session.get(f"http://{d.host}:{d.http_port}/metrics") as r:
                        r.raise_for_status()
                        text = await r.text()
                except (aiohttp.ClientError, asyncio.TimeoutError) as exc:
                    log.warning("cluster metrics scrape of %s failed: %s", d.instance, exc)
                    scrape_ok.labels(peer=d.instance).set(0.0)
                    return None
                scrape_ok.labels(peer=d.instance).set(1.0)
                return (d.instance, text)

            devices, scraped = await self._fan_out_shards(fetch)
            current = {d.instance for d in devices}
            for gone in self._scraped_peers - current:
                scrape_ok.labels(peer=gone).set(0.0)
            self._scraped_peers |= current
            sections.extend(scraped)
        # this node's section last built, first emitted: it carries this
        # very scrape's scrape_ok outcomes
        get_slo_tracker().snapshot()
        sections.insert(0, ("api", get_registry().expose()))
        body, skipped = federate(sections)
        for line in skipped:
            log.warning("cluster metrics: dropped unparseable line %s", line)
        return web.Response(body=body.encode("utf-8"), headers={"Content-Type": CONTENT_TYPE_LATEST})

    async def debug_timeline(self, request: web.Request) -> web.Response:
        """One request's flight-recorder spans (rid: the response id, the
        `cmpl-` form too) with its critical-path ledger; `?cluster=1` merges
        the shards' spans for it onto this node's clock."""
        rid = request.match_info["rid"]
        timeline = find_timeline(rid)
        if request.query.get("cluster", "").strip().lower() in _TRUE:
            stitched = await self._stitched_timeline(rid, timeline)
            if stitched is None:
                return _json_error(404, f"no recorded timeline for {rid!r} on any node", "not_found")
            stitched["critical_path"] = critical_path_section(stitched)
            return web.json_response(stitched)
        if timeline is None:
            return _json_error(404, f"no recorded timeline for {rid!r}", "not_found")
        payload = dict(timeline)
        payload["critical_path"] = critical_path_section(timeline)
        return web.json_response(payload)

    async def _stitched_timeline(self, rid: str, local: Optional[dict]) -> Optional[dict]:
        """The shards' halves of one request's timeline, each fetch doubling
        as the clock probe that places its spans on this node's clock (None
        when no node recorded the rid)."""
        internal = (local or {}).get("rid") or ("chat" + rid if rid.startswith("cmpl-") else rid)
        remotes = []
        if self.cluster_manager is not None:

            async def fetch(session, d):
                t0 = time.time()
                try:
                    async with session.get(f"http://{d.host}:{d.http_port}/v1/debug/timeline/{internal}") as r:
                        t1 = time.time()
                        if r.status == 404:
                            return None  # this shard saw no frame of the rid
                        r.raise_for_status()
                        tl = await r.json()
                    est = offset_from_probe(t0, float(tl["t_wall"]), t1)
                    tl["t_unix"] = float(tl["t_unix"])
                    assert isinstance(tl["spans"], list)
                except (aiohttp.ClientError, asyncio.TimeoutError, KeyError, TypeError, ValueError,
                        AssertionError) as exc:
                    log.warning("cluster timeline fetch from %s failed: %s", d.instance, exc)
                    return None
                return (d.instance, tl, est)

            _devices, remotes = await self._fan_out_shards(fetch)
        if local is None and not remotes:
            return None
        return stitch_timelines(local, remotes, rid=internal)

    async def debug_sched(self, request: web.Request) -> web.Response:
        """The scheduler's tick flight ring (sched/flight.py): per-tick
        token-budget use and waste, prefill / decode split, queue depths by
        state, preemptions, and KV block-pool occupancy.  `?last=N` trims
        the record list to the most recent N ticks."""
        snap = get_tick_recorder().snapshot()
        last = request.query.get("last", "").strip()
        if last:
            try:
                n = max(0, int(last))
            except ValueError:
                return _json_error(400, "last must be an integer")
            snap["records"] = snap["records"][-n:] if n else []
        return web.json_response(snap)

    async def debug_events(self, request: web.Request) -> web.Response:
        """The wide-event ring (obs/events.py): `?rid=` one request's,
        `?name=` one vocabulary entry's (400 for an unknown name), `?last_s=N`
        a trailing window; `?cluster=1` merges every shard's ring onto this
        node's clock."""
        rid = request.query.get("rid", "").strip()
        name = request.query.get("name", "").strip()
        if name and name not in EVENT_NAMES:
            return _json_error(400, f"unknown event name {name!r} (one of {sorted(EVENT_NAMES)})")
        last_raw = request.query.get("last_s", "").strip()
        try:
            last_s = float(last_raw) if last_raw else 0.0
        except ValueError:
            return _json_error(400, "last_s must be a number")
        ring = get_event_ring()
        events = ring.query(rid=rid, name=name, last_s=last_s)
        dropped = ring.dropped
        if request.query.get("cluster", "").strip().lower() in _TRUE and self.cluster_manager is not None:
            params = {k: v for k, v in (("rid", rid), ("name", name), ("last_s", str(last_s) if last_s else ""))
                      if v}

            async def fetch(session, d):
                t0 = time.time()
                try:
                    async with session.get(f"http://{d.host}:{d.http_port}/v1/debug/events", params=params) as r:
                        t1 = time.time()
                        r.raise_for_status()
                        body = await r.json()
                    est = offset_from_probe(t0, float(body["t_wall"]), t1)
                    remote = body["events"]
                    assert isinstance(remote, list)
                except (aiohttp.ClientError, asyncio.TimeoutError, KeyError, TypeError, ValueError,
                        AssertionError) as exc:
                    log.warning("cluster events fetch from %s failed: %s", d.instance, exc)
                    return None
                return (d.instance, remote, est)

            _devices, remotes = await self._fan_out_shards(fetch)
            events = merge_remote_events(events, remotes)
        return web.json_response({"events": events, "dropped": dropped})

    async def debug_trace(self, request: web.Request) -> web.Response:
        """One request as Chrome trace-event / Perfetto JSON (obs/trace.py),
        its wide events as instants; `?cluster=1` stitches the shards' spans
        in first.  `?format=` takes only perfetto / chrome."""
        fmt = request.query.get("format", "perfetto").strip().lower()
        if fmt not in ("perfetto", "chrome"):
            return _json_error(400, f"unknown trace format {fmt!r}")
        rid = request.match_info["rid"]
        timeline = find_timeline(rid)
        if request.query.get("cluster", "").strip().lower() in _TRUE:
            timeline = await self._stitched_timeline(rid, timeline)
        if timeline is None:
            return _json_error(404, f"no recorded timeline for {rid!r}", "not_found")
        internal = timeline.get("rid") or rid
        return web.json_response(export_trace(
            [timeline],
            tick_records=get_tick_recorder().snapshot()["records"],
            wide_events=get_event_ring().query(rid=internal),
        ))

    async def debug_trace_window(self, request: web.Request) -> web.Response:
        """The serving window as one trace: every retained timeline whose
        request began in the last `last_s` seconds (DNET_OBS_TRACE_WINDOW_S
        by default), the tick records as counter tracks, the window's wide
        events as instants."""
        last_raw = request.query.get("last_s", "").strip()
        try:
            last_s = float(last_raw) if last_raw else obs_settings().trace_window_s
        except ValueError:
            return _json_error(400, "last_s must be a number")
        recorder = get_recorder()
        timelines = [
            tl for rid in recorder.request_ids_since(time.time() - last_s)
            if (tl := recorder.timeline(rid)) is not None
        ]
        return web.json_response(export_trace(
            timelines,
            tick_records=get_tick_recorder().snapshot()["records"],
            wide_events=get_event_ring().query(last_s=last_s),
        ))
