"""Shard control-plane HTTP server (aiohttp).

Counterpart of dnet_tpu/shard/http.py, trimmed to /load_model,
/unload_model, /health and /cleanup_repacked (which deletes the weight-
streaming repack cache: the loaded model's subtree, or the whole cache
when none is loaded; 409 while a streaming engine reads it).  `ShardLoadModelRequest` keeps every field of
the reference's, so an API node of either package can load this shard;
the options this slice does not serve answer 422 (shard/compute.py).
/health carries the kernels' launch counts in this process, the hop
codec's frame and byte counts, and the engine's weight plan (and, when it
streams, `engine.weight_cache`: loads, hits, evictions and bytes).
"""

from __future__ import annotations

import asyncio
import json
import shutil
import time
from pathlib import Path
from typing import List, Optional

from aiohttp import web
from pydantic import BaseModel, ValidationError

from dnet_tpu_torch.config import shard_settings
from dnet_tpu_torch.kernels import launch_counts
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


def _error(status: int, message: str) -> web.Response:
    return web.json_response({"status": "error", "message": message}, status=status)


class ShardHTTPServer:
    def __init__(self, shard) -> None:
        self.shard = shard  # the Shard facade (runtime + adapter)
        self.app = web.Application(client_max_size=16 * 1024 * 1024)
        self.app.router.add_get("/health", self.health)
        self.app.router.add_post("/load_model", self.load_model)
        self.app.router.add_post("/unload_model", self.unload_model)
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

    async def health(self, request: web.Request) -> web.Response:
        rt = self.shard.runtime
        compute = rt.compute
        body = {
            "status": "ok",
            "role": "shard",
            "shard_id": rt.shard_id,
            "model": rt.model_path or None,
            "layers": list(compute.layers) if compute else [],
            "queue_depth": rt.queue_depth,
            "epoch": rt.epoch,
            "device": str(rt.device),
            "kernels": launch_counts(),
            "compute": dict(rt.compute_stats),
        }
        if compute is not None:
            body["sessions"] = len(compute.engine.sessions)
            body["wire_codec"] = compute.wire_codec
            body["wire"] = dict(compute.wire_stats)
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

    async def unload_model(self, request: web.Request) -> web.Response:
        await self.shard.unload_model()
        return web.json_response({"status": "ok"})

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
