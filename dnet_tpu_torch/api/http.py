"""API-node HTTP server (aiohttp): the OpenAI-compatible routes of this slice.

Counterpart of dnet_tpu/api/http.py, trimmed to
  POST /v1/chat/completions  SSE streaming + aggregate
  POST /v1/completions       legacy text completions
  GET  /v1/models            the catalog with its quant variants, and the
                             loaded model
  POST /v1/load_model        load a local checkpoint (in ring mode: the
                             fan-out to the shards)
  POST /v1/prepare_topology_manual
                             ring mode: assign layer ranges to shards
  GET  /health
  GET  /v1/debug/sched       the scheduler's tick flight ring (?last=N)
with the reference's serialization, so the same request gets the same
bytes back (SSE: `data: <json>\\n\\n` frames, then `data: [DONE]`).
"""

from __future__ import annotations

import inspect
import json
from typing import Optional

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
    completion_logprobs,
)
from dnet_tpu_torch.api.catalog import expanded_catalog, split_variant
from dnet_tpu_torch.api.model_manager import resolve_model_dir
from dnet_tpu_torch.api.ring_manager import build_manual_topology
from dnet_tpu_torch.api.schemas import (
    ChatCompletionRequest,
    CompletionRequest,
    HealthResponse,
    LoadModelRequest,
    LoadModelResponse,
    ModelInfo,
    ModelList,
    PrepareTopologyManualRequest,
)
from dnet_tpu_torch.sched.flight import get_tick_recorder
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


def _json_error(
    status: int, message: str, err_type: str = "invalid_request_error",
    headers: Optional[dict] = None,
):
    return web.json_response(
        {"error": {"message": message, "type": err_type}}, status=status, headers=headers
    )


class ApiHTTPServer:
    def __init__(self, inference: InferenceManager, model_manager, cluster_manager=None) -> None:
        self.inference = inference
        self.model_manager = model_manager
        self.cluster_manager = cluster_manager  # ring mode only
        self.app = web.Application(client_max_size=64 * 1024 * 1024)
        self.app.router.add_post("/v1/chat/completions", self.chat_completions)
        self.app.router.add_post("/v1/completions", self.completions)
        self.app.router.add_get("/v1/models", self.list_models)
        self.app.router.add_post("/v1/load_model", self.load_model)
        self.app.router.add_post("/v1/prepare_topology_manual", self.prepare_topology_manual)
        self.app.router.add_get("/health", self.health)
        self.app.router.add_get("/v1/debug/sched", self.debug_sched)
        self._runner: Optional[web.AppRunner] = None

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
        if not self.inference.ready:
            return _json_error(400, "no model loaded; POST /v1/load_model first")
        return None

    @staticmethod
    def _map_inference_errors(exc: Exception):
        if isinstance(exc, AdmissionRejected):
            # Retry-After is integral seconds per RFC 9110; never 0
            return _json_error(429, str(exc), "rate_limit_exceeded",
                               {"Retry-After": str(max(1, round(exc.retry_after_s)))})
        if isinstance(exc, BackpressureError):
            # no service-time estimate here: advertise the 1 s floor
            return _json_error(429, str(exc), "rate_limit_exceeded", {"Retry-After": "1"})
        if isinstance(exc, DeadlineExceededError):
            return _json_error(504, str(exc), "deadline_exceeded")
        if isinstance(exc, PromptTooLongError):
            return _json_error(400, str(exc))
        if isinstance(exc, EngineCapabilityError):
            # the serving config asked the engine for something it cannot do
            return _json_error(422, str(exc), "invalid_request_error")
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
                for payload in reshape(chunk):
                    await resp.write(f"data: {payload}\n\n".encode())

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

    async def prepare_topology_manual(self, request: web.Request) -> web.Response:
        """Manual layer assignment -> the ring topology (needs a hostfile)."""
        if self.cluster_manager is None:
            return _json_error(400, "not in ring mode (start with --hostfile)")
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
        return web.json_response({
            "status": "ok",
            "topology": {
                "model": topo.model,
                "num_layers": topo.num_layers,
                "epoch": topo.epoch,
                "assignments": [
                    {"instance": a.instance, "layers": a.layers, "next_instance": a.next_instance,
                     "mesh_tp": a.mesh_tp, "mesh_sp": a.mesh_sp}
                    for a in topo.assignments
                ],
            },
        })

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

    async def health(self, request: web.Request) -> web.Response:
        body = HealthResponse(model=self.model_manager.current_model_id).model_dump()
        body["admission"] = {
            "active": self.inference.active,
            "capacity": self.inference.max_concurrent,
        }
        stats = getattr(getattr(self.model_manager, "engine", None), "stats", None)
        if stats is not None:
            body["engine"] = stats()
        return web.json_response(body)
