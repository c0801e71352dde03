"""Shard-node process wiring: ShardRuntime + RingAdapter + gRPC + HTTP.

Counterpart of dnet_tpu/shard/server.py (no TUI).  A malformed DNET_CHAOS
stops the shard at start (resilience/chaos.py `validate_startup`).  With
--discovery udp (the default) the shard announces its id and ports over
UDP (utils/p2p.py `UdpDiscovery`) once it serves; when the socket cannot
bind it warns and serves hostfile rings only, as the reference's does.  `update_topology` is a delta
reload's shard half: the weights stay, the per-request state goes, the new
epoch is pinned and the next hop rewired.  `serve_async` runs until
SIGINT/SIGTERM and shuts down in order: discovery, HTTP, gRPC, adapter,
runtime.
"""

from __future__ import annotations

import asyncio
import contextlib
import signal
import socket

from dnet_tpu_torch.api.model_manager import resolve_model_dir
from dnet_tpu_torch.config import shard_settings, transport_settings
from dnet_tpu_torch.resilience import chaos
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
                # 0 = this shard's own DNET_SHARD_MESH_* default; a tp_degree
                # of 0 resolves to its own DNET_TP (shard/compute.py)
                mesh_tp=req.mesh_tp or shard_settings().mesh_tp, mesh_sp=req.mesh_sp or shard_settings().mesh_sp,
                tp_degree=req.tp_degree,
                spec_lookahead=req.spec_lookahead, lanes=req.lanes, prefix_cache=req.prefix_cache,
                # read by the engine only under a streaming plan
                repack_dir=shard_settings().repack_dir,
            ),
        )
        await self.adapter.reset_topology()
        self.adapter.configure_topology(
            f"{req.next_node.host}:{req.next_node.grpc_port}" if req.next_node else ""
        )

    async def update_topology(self, req) -> None:
        """Delta reconfiguration: this shard's load body is unchanged in the
        new topology, so it keeps its weights and (1) proves it holds the
        model and layers the API expects, (2) drops every per-request state
        (KV sessions, queued frames, streams, dedup keys), (3) pins the new
        epoch, (4) rewires its next hop.  Raises ValueError when the proof
        fails (the HTTP layer answers 409 and the API loads in full)."""
        await chaos.inject_async("update_topology")
        compute = self.runtime.compute
        if compute is None:
            raise ValueError("no model loaded; cannot delta-update")
        model_dir = resolve_model_dir(req.model_path, self.models_dir)
        if model_dir is None or str(model_dir) != self.runtime.model_path:
            raise ValueError(
                f"loaded model {self.runtime.model_path!r} does not match requested {req.model_path!r}"
            )
        if sorted(compute.layers) != sorted(req.layers):
            raise ValueError(f"loaded layers {sorted(compute.layers)} do not match requested {sorted(req.layers)}")
        await self.adapter.reset_topology()
        self.runtime.drain_ingress()
        compute.reset("")
        # off the loop: set_epoch takes the model lock, which a concurrent
        # full reload holds for its whole weight read
        await asyncio.get_running_loop().run_in_executor(None, self.runtime.set_epoch, req.epoch)
        next_addr = f"{req.next_node.host}:{req.next_node.grpc_port}" if req.next_node else ""
        self.adapter.configure_topology(next_addr)
        log.info("shard %s delta-updated to epoch %d (next=%s, weights kept)", self.shard_id, req.epoch,
                 next_addr or "<none>")

    async def unload_model(self) -> None:
        await self.adapter.reset_topology()
        await asyncio.get_running_loop().run_in_executor(None, self.runtime.unload_model_core)


async def serve_async(args) -> None:
    from dnet_tpu_torch.transport.grpc_transport import ring_service_handlers, start_grpc_server

    # a malformed DNET_CHAOS stops the shard here, never mid-request
    chaos.validate_startup(role="shard")
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
    discovery = _announce(args, shard_id)
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
        if discovery is not None:
            discovery.stop()
        sweeper.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await sweeper
        await http.stop()
        await grpc_server.stop(grace=2)
        await shard.stop()


def _announce(args, shard_id: str):
    """The shard's UdpDiscovery under --discovery udp, or None (off, or
    discovery could not start: the library did not build or load, or the
    socket could not bind; hostfile rings still reach the shard)."""
    if getattr(args, "discovery", "none") != "udp":
        return None
    from dnet_tpu_torch.utils.p2p import DEFAULT_TARGET, DEFAULT_UDP_PORT, UdpDiscovery

    try:
        discovery = UdpDiscovery(
            shard_id, args.http_port, args.grpc_port, udp_port=getattr(args, "udp_port", DEFAULT_UDP_PORT),
            target_addr=getattr(args, "udp_target", DEFAULT_TARGET), cluster=getattr(args, "cluster", "default"),
        )
    except Exception as exc:
        log.warning("UDP discovery unavailable (%s); hostfile mode only", exc)
        return None
    log.info("UDP discovery announcing as %s", shard_id)
    return discovery


def serve(args) -> None:
    asyncio.run(serve_async(args))
