"""API-node process wiring: inference manager, model manager, HTTP server.

Counterpart of dnet_tpu/api/server.py for single-process serving (on one
device, or over pipeline stages and sequence-parallel ranks with --mesh
pp=P,sp=N or DNET_MESH_PP / _SP) and, with --hostfile or --discovery udp,
for a ring of shards (no fleet or TUI).  Under --discovery udp the API
announces itself as a manager (utils/p2p.py `UdpDiscovery`, scoped by
--cluster) and its ClusterManager reads the live peer table, as the
reference's does; discovery stops at shutdown.
In ring mode the API also listens on gRPC for the tail shard's token
callbacks and runs the `RingFailureMonitor` (api/failure.py): health
probes every DNET_API_HEALTH_INTERVAL_S, fast-fail and 503 once a shard
misses DNET_API_HEALTH_FAIL_THRESHOLD in a row, and with --auto-recover a
re-solve and delta reload over the healthy shards.  A malformed DNET_CHAOS
stops the server at start (resilience/chaos.py `validate_startup`).  `serve_async` runs until SIGINT/SIGTERM, then drains as the
reference does: admission enters drain mode (/health reads "draining", new
work gets 503 + Retry-After, queued requests are shed) while the HTTP
server stays up, so in-flight streams finish within DNET_DRAIN_DEADLINE_S;
only then does it tear down.
"""

from __future__ import annotations

import asyncio
import signal
from typing import Optional

from dnet_tpu_torch.api.http import ApiHTTPServer
from dnet_tpu_torch.api.inference import InferenceManager
from dnet_tpu_torch.api.model_manager import LocalModelManager
from dnet_tpu_torch.config import admission_settings, batch_slots_default, kv_settings, mesh_settings
from dnet_tpu_torch.parallel.mesh import parse_mesh
from dnet_tpu_torch.resilience import chaos
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


def resolve_mesh(args) -> Optional[dict]:
    """--mesh, else the DNET_MESH_* axes when they ask for a mesh (the
    reference's precedence).  Raises ValueError for a malformed spec and for
    the multi-host settings the port does not serve (DNET_MESH_BACKEND,
    _COORDINATOR, _NUM_PROCESSES, _PROCESS_ID)."""
    ms = mesh_settings()
    for name, value, default in (("BACKEND", ms.backend, ""), ("COORDINATOR", ms.coordinator, ""),
                                 ("NUM_PROCESSES", ms.num_processes, 0), ("PROCESS_ID", ms.process_id, 0)):
        if value != default:
            raise ValueError(f"DNET_MESH_{name}={value!r}: multi-host meshes are not ported; unset it to serve")
    return parse_mesh(getattr(args, "mesh", "") or "") or ms.axes()


async def serve_async(args) -> None:
    # a malformed DNET_CHAOS stops the server here, never mid-request
    chaos.validate_startup(role="api")
    batch_slots = batch_slots_default(getattr(args, "batch_slots", None))
    # with continuous batching, admission must not exceed the slot pool: an
    # over-admitted request would fail on prefill instead of queueing
    max_concurrent = min(args.max_concurrent, batch_slots) if batch_slots > 1 else args.max_concurrent
    inference = InferenceManager(
        adapter=None,
        request_timeout_s=args.request_timeout_s,
        max_concurrent=max_concurrent,
    )
    cluster_manager = grpc_server = monitor = discovery = None
    if getattr(args, "hostfile", "") or getattr(args, "discovery", "none") == "udp":
        model_manager, cluster_manager, grpc_server = await _ring_mode(args, inference)
        discovery = cluster_manager.discovery
        from dnet_tpu_torch.api.failure import RingFailureMonitor
        from dnet_tpu_torch.config import api_settings

        s = api_settings()
        monitor = RingFailureMonitor(
            cluster_manager, inference, model_manager=model_manager, interval_s=s.health_interval_s,
            fail_threshold=s.health_fail_threshold, auto_recover=getattr(args, "auto_recover", False),
        )
        inference.failure_monitor = monitor
        monitor.start()
    else:
        model_manager = LocalModelManager(
            inference,
            models_dir=args.models_dir,
            max_seq=args.max_seq_len,
            param_dtype=args.param_dtype,
            device=args.device,
            batch_slots=batch_slots,
            kv_bits=kv_settings().bits,
            mesh=resolve_mesh(args),
            # a programmatic caller may place the ranks itself (several on
            # one card); the CLI never does
            mesh_devices=getattr(args, "mesh_devices", None),
        )
    http = ApiHTTPServer(inference, model_manager, cluster_manager)
    await http.start(args.host, args.http_port)
    try:
        if args.model:
            await model_manager.load_model(args.model)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        log.info("dnet-torch-api ready")
        await stop.wait()
        drain_s = admission_settings().drain_deadline_s
        log.info("shutdown signal: draining %d in-flight request(s) (bounded %.1fs)",
                 inference.admission.active, drain_s)
        inference.admission.begin_drain()
        if await inference.admission.wait_drained(drain_s):
            log.info("drain complete; shutting down")
        else:
            log.warning("drain deadline hit; shutting down with work in flight")
    finally:
        if hasattr(discovery, "stop"):  # UdpDiscovery (a hostfile's table has nothing to stop)
            discovery.stop()
        await http.stop()
        if monitor is not None:
            await monitor.stop()
        if grpc_server is not None:
            await grpc_server.stop(grace=2)
        if inference.adapter is not None:
            await inference.adapter.shutdown()


def _ring_discovery(args):
    """The ring's peer table: the hostfile's, else (--discovery udp) a
    manager-side UdpDiscovery of the --cluster's shards."""
    from dnet_tpu_torch.utils.hostfile import StaticDiscovery
    from dnet_tpu_torch.utils.p2p import DEFAULT_TARGET, DEFAULT_UDP_PORT, UdpDiscovery

    if getattr(args, "hostfile", ""):
        return StaticDiscovery.from_hostfile(args.hostfile)
    discovery = UdpDiscovery(
        "api", args.http_port, args.grpc_port, is_manager=True,
        udp_port=getattr(args, "udp_port", DEFAULT_UDP_PORT),
        target_addr=getattr(args, "udp_target", DEFAULT_TARGET), cluster=getattr(args, "cluster", "default"),
    )
    log.info("UDP discovery active (manager)")
    return discovery


async def _ring_mode(args, inference):
    """The ring's shards (a hostfile's, or those UDP discovery hears), the
    ring model manager, and the gRPC server the tail shard calls back with
    each sampled token."""
    from dnet_tpu_torch.api.cluster import ClusterManager
    from dnet_tpu_torch.api.ring import ApiTokenServicer
    from dnet_tpu_torch.api.ring_manager import RingModelManager
    from dnet_tpu_torch.config import api_settings
    from dnet_tpu_torch.transport.grpc_transport import api_service_handlers, start_grpc_server

    discovery = _ring_discovery(args)
    cluster_manager = ClusterManager(discovery)
    # unset: each load resolves the address facing its shards
    callback_addr = api_settings().callback_addr
    model_manager = RingModelManager(
        inference,
        cluster_manager,
        models_dir=args.models_dir,
        api_callback_addr=callback_addr,
        callback_port=args.grpc_port,
        max_seq=args.max_seq_len,
        param_dtype=args.param_dtype,
        request_timeout_s=args.request_timeout_s,
    )

    def resolve(result) -> None:
        if inference.adapter is None:
            log.warning("token for %s before model load", result.nonce)
        else:
            inference.adapter.resolve_token(result)

    grpc_server = await start_grpc_server(
        args.host, args.grpc_port, api_service_handlers(ApiTokenServicer(resolve))
    )
    log.info("ring mode: %d shard(s) from %s, callbacks on %s", len(discovery.peers()),
             args.hostfile or "udp discovery", callback_addr or f"port {args.grpc_port}, host resolved at load")
    return model_manager, cluster_manager, grpc_server


def serve(args) -> None:
    asyncio.run(serve_async(args))
