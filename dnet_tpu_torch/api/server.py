"""API-node process wiring: inference manager, model manager, HTTP server.

Counterpart of dnet_tpu/api/server.py for single-process serving (no
ring, mesh, fleet or TUI).  `serve_async` runs until SIGINT/SIGTERM.
"""

from __future__ import annotations

import asyncio
import signal

from dnet_tpu_torch.api.http import ApiHTTPServer
from dnet_tpu_torch.api.inference import InferenceManager
from dnet_tpu_torch.api.model_manager import LocalModelManager
from dnet_tpu_torch.config import batch_slots_default
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


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
    model_manager = LocalModelManager(
        inference,
        models_dir=args.models_dir,
        max_seq=args.max_seq_len,
        param_dtype=args.param_dtype,
        device=args.device,
        batch_slots=batch_slots,
    )
    http = ApiHTTPServer(inference, model_manager)
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
        if inference.adapter is not None:
            await inference.adapter.shutdown()


def serve(args) -> None:
    asyncio.run(serve_async(args))
