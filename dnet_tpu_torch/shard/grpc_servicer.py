"""Shard gRPC servicer: the ring's data-plane endpoints.

Counterpart of dnet_tpu/shard/grpc_servicer.py: the bidi StreamActivations
with one ACK per frame, unary SendActivation, HealthCheck (assigned layers
and queue depth) and ResetCache.
"""

from __future__ import annotations

from dnet_tpu_torch.transport.protocol import (
    ActivationFrame,
    Empty,
    HealthInfo,
    ResetCacheRequest,
    StreamAck,
)


class ShardRingServicer:
    def __init__(self, adapter, runtime) -> None:
        self.adapter = adapter
        self.runtime = runtime

    async def stream_activations(self, request_iterator, context):
        async for frame in request_iterator:
            ok, message = await self.adapter.ingress_frame(frame)
            yield StreamAck(
                nonce=frame.nonce, seq=frame.seq, ok=ok,
                backpressure=(message == "backpressure"), message=message,
            )

    async def send_activation(self, frame: ActivationFrame, context) -> StreamAck:
        ok, message = await self.adapter.ingress_frame(frame)
        return StreamAck(nonce=frame.nonce, seq=frame.seq, ok=ok, message=message)

    async def health_check(self, request: Empty, context) -> HealthInfo:
        compute = self.runtime.compute
        return HealthInfo(
            ok=True,
            model=self.runtime.model_path,
            layers=list(compute.layers) if compute else [],
            queue_depth=self.runtime.queue_depth,
            epoch=self.runtime.epoch,
        )

    async def reset_cache(self, request: ResetCacheRequest, context) -> Empty:
        await self.adapter.reset_cache(request.nonce)
        return Empty()
