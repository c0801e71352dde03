"""Shard-node process wiring: ShardRuntime + RingAdapter + gRPC + HTTP.

Counterpart of dnet_tpu/shard/server.py for hostfile rings (no UDP
discovery, TUI or delta topology updates).  `serve_async` runs until
SIGINT/SIGTERM and shuts down in order: HTTP, gRPC, adapter, runtime.
"""

from __future__ import annotations

import asyncio
import contextlib
import signal
import socket

from dnet_tpu_torch.api.model_manager import resolve_model_dir
from dnet_tpu_torch.config import shard_settings, transport_settings
from dnet_tpu_torch.shard.adapter import RingAdapter
from dnet_tpu_torch.shard.grpc_servicer import ShardRingServicer
from dnet_tpu_torch.shard.http import ShardHTTPServer, ShardLoadModelRequest
from dnet_tpu_torch.shard.runtime import ShardRuntime
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


class Shard:
    """Facade over the runtime and the adapter."""

    def __init__(self, shard_id: str, runtime: ShardRuntime, adapter: RingAdapter, models_dir: str = "") -> None:
        self.shard_id = shard_id
        self.runtime = runtime
        self.adapter = adapter
        self.models_dir = models_dir

    async def start(self) -> None:
        self.runtime.start(asyncio.get_running_loop())
        await self.adapter.start()

    async def stop(self) -> None:
        await self.adapter.shutdown()
        self.runtime.stop()

    async def load_model(self, req: ShardLoadModelRequest) -> None:
        model_dir = resolve_model_dir(req.model_path, self.models_dir)
        if model_dir is None:
            raise FileNotFoundError(f"model {req.model_path!r} not found on shard")
        await asyncio.get_running_loop().run_in_executor(
            None,
            lambda: self.runtime.load_model_core(
                str(model_dir), req.layers, epoch=req.epoch, max_seq=req.max_seq_len,
                param_dtype=req.param_dtype, wire_dtype=req.wire_dtype, wire_codec=req.wire_codec,
                window_size=req.window_size, residency_size=req.residency_size,
                kv_bits=req.kv_bits, weight_quant_bits=req.weight_quant_bits,
                mesh_tp=req.mesh_tp, mesh_sp=req.mesh_sp, tp_degree=req.tp_degree,
                spec_lookahead=req.spec_lookahead, lanes=req.lanes, prefix_cache=req.prefix_cache,
                # read by the engine only under a streaming plan
                repack_dir=shard_settings().repack_dir,
            ),
        )
        await self.adapter.reset_topology()
        self.adapter.configure_topology(
            f"{req.next_node.host}:{req.next_node.grpc_port}" if req.next_node else ""
        )

    async def unload_model(self) -> None:
        await self.adapter.reset_topology()
        await asyncio.get_running_loop().run_in_executor(None, self.runtime.unload_model_core)


async def serve_async(args) -> None:
    from dnet_tpu_torch.transport.grpc_transport import ring_service_handlers, start_grpc_server

    t = transport_settings()
    shard_id = args.shard_name or f"shard-{socket.gethostname()}-{args.grpc_port}"
    runtime = ShardRuntime(shard_id, queue_size=args.queue_size, device=args.device)
    adapter = RingAdapter(runtime, stream_idle_s=t.stream_idle_sweep_s, backoff_s=t.stream_backoff_s)
    shard = Shard(shard_id, runtime, adapter, models_dir=args.models_dir)
    await shard.start()
    grpc_server = await start_grpc_server(
        args.host, args.grpc_port, ring_service_handlers(ShardRingServicer(adapter, runtime))
    )
    http = ShardHTTPServer(shard)
    await http.start(args.host, args.http_port)
    sweeper = asyncio.ensure_future(runtime.sweeper())
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    log.info("dnet-torch-shard %s ready (grpc %d, http %d, %s)", shard_id, args.grpc_port,
             args.http_port, args.device)
    try:
        await stop.wait()
        log.info("shard shutting down")
    finally:
        sweeper.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await sweeper
        await http.stop()
        await grpc_server.stop(grace=2)
        await shard.stop()


def serve(args) -> None:
    asyncio.run(serve_async(args))
