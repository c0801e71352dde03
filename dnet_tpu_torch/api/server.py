"""API-node process wiring: inference manager, model manager, HTTP server.

Counterpart of dnet_tpu/api/server.py for single-process serving (on one
device, or over sequence-parallel ranks with --mesh sp=N or DNET_MESH_SP)
and, with --hostfile, for a ring of shards (no UDP discovery, fleet or
TUI).
In ring mode the API also listens on gRPC for the tail shard's token
callbacks.  `serve_async` runs until SIGINT/SIGTERM.
"""

from __future__ import annotations

import asyncio
import signal
from typing import Optional

from dnet_tpu_torch.api.http import ApiHTTPServer
from dnet_tpu_torch.api.inference import InferenceManager
from dnet_tpu_torch.api.model_manager import LocalModelManager
from dnet_tpu_torch.config import batch_slots_default, kv_settings, mesh_settings
from dnet_tpu_torch.parallel.mesh import parse_mesh
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
    batch_slots = batch_slots_default(getattr(args, "batch_slots", None))
    # with continuous batching, admission must not exceed the slot pool: an
    # over-admitted request would fail on prefill instead of queueing
    max_concurrent = min(args.max_concurrent, batch_slots) if batch_slots > 1 else args.max_concurrent
    inference = InferenceManager(
        adapter=None,
        request_timeout_s=args.request_timeout_s,
        max_concurrent=max_concurrent,
    )
    cluster_manager = grpc_server = None
    if getattr(args, "hostfile", ""):
        model_manager, cluster_manager, grpc_server = await _ring_mode(args, inference)
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
        log.info("shutdown signal: stopping")
    finally:
        await http.stop()
        if grpc_server is not None:
            await grpc_server.stop(grace=2)
        if inference.adapter is not None:
            await inference.adapter.shutdown()


async def _ring_mode(args, inference):
    """The hostfile's shards, the ring model manager, and the gRPC server
    the tail shard calls back with each sampled token."""
    from dnet_tpu_torch.api.cluster import ClusterManager
    from dnet_tpu_torch.api.ring import ApiTokenServicer
    from dnet_tpu_torch.api.ring_manager import RingModelManager
    from dnet_tpu_torch.config import api_settings
    from dnet_tpu_torch.transport.grpc_transport import api_service_handlers, start_grpc_server
    from dnet_tpu_torch.utils.hostfile import StaticDiscovery
    from dnet_tpu_torch.utils.network import primary_ip

    discovery = StaticDiscovery.from_hostfile(args.hostfile)
    cluster_manager = ClusterManager(discovery)
    callback_addr = api_settings().callback_addr or (
        f"{primary_ip(d.host for d in discovery.peers())}:{args.grpc_port}"
    )
    model_manager = RingModelManager(
        inference,
        cluster_manager,
        models_dir=args.models_dir,
        api_callback_addr=callback_addr,
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
    log.info("ring mode: %d shard(s) from %s, callbacks on %s", len(discovery.peers()), args.hostfile,
             callback_addr)
    return model_manager, cluster_manager, grpc_server


def serve(args) -> None:
    asyncio.run(serve_async(args))
