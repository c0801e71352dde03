"""Shard gRPC servicer: the ring's data-plane endpoints.

Counterpart of dnet_tpu/shard/grpc_servicer.py: the bidi StreamActivations
with one ACK per frame, unary SendActivation, HealthCheck (assigned layers
and queue depth), ResetCache (fenced by the topology epoch: a reset minted
under another epoch raises, counted as kind "reset_cache") and the
MeasureLatency echo.
"""

from __future__ import annotations

import time

from dnet_tpu_torch.membership import epoch as epoch_fence
from dnet_tpu_torch.transport.protocol import (
    ActivationFrame,
    Empty,
    HealthInfo,
    LatencyProbe,
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
        # a reset from a dead topology must not clear the live ring's
        # sessions; epoch 0 is the unfenced admin reset
        held = self.runtime.epoch
        if epoch_fence.is_stale(held, request.epoch):
            raise epoch_fence.reject("reset_cache", held, request.epoch)
        await self.adapter.reset_cache(request.nonce)
        return Empty()

    async def measure_latency(self, probe: LatencyProbe, context) -> LatencyProbe:
        # echo the payload; `t_remote` makes the probe a clock-offset sample
        return LatencyProbe(t_sent=probe.t_sent, payload=probe.payload, t_remote=time.time())
