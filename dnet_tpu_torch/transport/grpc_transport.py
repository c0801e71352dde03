"""gRPC channel and server glue for the ring (generic methods, no codegen).

Counterpart of dnet_tpu/transport/grpc_transport.py: 64 MiB messages,
1024 streams, conservative keepalive, BDP probe off, no proxy.
`RingClient` streams frames to a peer shard, resets a nonce's KV there,
probes its health (the failure monitor) and echoes latency probes (the
profiler); `ApiCallbackClient` carries a shard's sampled token back to the
API.  Unary RPCs retry transient failures under their class's policy
(resilience/policy.py); `health_check`'s class is pinned to one attempt,
because the failure monitor's threshold is the probe's retry budget.
"""

from __future__ import annotations

import grpc
import grpc.aio as aio_grpc

from dnet_tpu_torch.transport import protocol as proto
from dnet_tpu_torch.resilience.policy import call_with_retry
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


def channel_options() -> list:
    """The reference's default channel settings (its DNET_GRPC_*)."""
    mb = 64 * 1024 * 1024
    return [
        ("grpc.max_send_message_length", mb),
        ("grpc.max_receive_message_length", mb),
        ("grpc.max_concurrent_streams", 1024),
        ("grpc.keepalive_time_ms", 20000),
        ("grpc.keepalive_timeout_ms", 10000),
        ("grpc.http2.bdp_probe", 0),
        ("grpc.enable_http_proxy", 0),
    ]


def make_channel(addr: str) -> aio_grpc.Channel:
    return aio_grpc.insecure_channel(addr, options=channel_options())


def _serialize(msg) -> bytes:
    return msg.to_bytes()


class RingClient:
    """Client side of the ring: a frame stream to a peer shard and the
    unary control RPCs (transient failures retried)."""

    def __init__(self, addr: str) -> None:
        self.addr = addr
        self.channel = make_channel(addr)
        self._stream_stream = self.channel.stream_stream(
            proto.M_STREAM_ACTIVATIONS,
            request_serializer=_serialize,
            response_deserializer=proto.StreamAck.from_bytes,
        )
        self._health = self.channel.unary_unary(
            proto.M_HEALTH_CHECK,
            request_serializer=_serialize,
            response_deserializer=proto.HealthInfo.from_bytes,
        )
        self._reset = self.channel.unary_unary(
            proto.M_RESET_CACHE,
            request_serializer=_serialize,
            response_deserializer=proto.Empty.from_bytes,
        )
        self._latency = self.channel.unary_unary(
            proto.M_MEASURE_LATENCY,
            request_serializer=_serialize,
            response_deserializer=proto.LatencyProbe.from_bytes,
        )

    def open_stream(self):
        return self._stream_stream()

    async def health_check(self, timeout: float = 5.0) -> proto.HealthInfo:
        return await call_with_retry(lambda: self._health(proto.Empty(), timeout=timeout), method="health_check")

    async def measure_latency(self, probe: proto.LatencyProbe, timeout: float = 30.0) -> proto.LatencyProbe:
        return await call_with_retry(lambda: self._latency(probe, timeout=timeout), method="measure_latency")

    async def reset_cache(self, nonce: str = "", timeout: float = 10.0, epoch: int = 0):
        return await call_with_retry(
            lambda: self._reset(proto.ResetCacheRequest(nonce=nonce, epoch=epoch), timeout=timeout),
            method="reset_cache",
        )

    async def close(self) -> None:
        await self.channel.close()


class ApiCallbackClient:
    """Shard -> API unary token callback."""

    def __init__(self, addr: str) -> None:
        self.addr = addr
        self.channel = make_channel(addr)
        self._send_token = self.channel.unary_unary(
            proto.M_SEND_TOKEN,
            request_serializer=_serialize,
            response_deserializer=proto.Empty.from_bytes,
        )

    async def send_token(self, payload: proto.TokenPayload, timeout: float = 3.0):
        return await self._send_token(payload, timeout=timeout)

    async def close(self) -> None:
        await self.channel.close()


# ---- server side -------------------------------------------------------------


def ring_service_handlers(servicer) -> grpc.GenericRpcHandler:
    """servicer provides stream_activations (an async generator),
    send_activation, health_check, reset_cache and measure_latency."""
    unary = {
        "SendActivation": (servicer.send_activation, proto.ActivationFrame),
        "HealthCheck": (servicer.health_check, proto.Empty),
        "ResetCache": (servicer.reset_cache, proto.ResetCacheRequest),
        "MeasureLatency": (servicer.measure_latency, proto.LatencyProbe),
    }
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=cls.from_bytes, response_serializer=_serialize
        )
        for name, (fn, cls) in unary.items()
    }
    handlers["StreamActivations"] = grpc.stream_stream_rpc_method_handler(
        servicer.stream_activations,
        request_deserializer=proto.ActivationFrame.from_bytes,
        response_serializer=_serialize,
    )
    return grpc.method_handlers_generic_handler(proto.RING_SERVICE, handlers)


def api_service_handlers(servicer) -> grpc.GenericRpcHandler:
    return grpc.method_handlers_generic_handler(
        proto.API_SERVICE,
        {
            "SendToken": grpc.unary_unary_rpc_method_handler(
                servicer.send_token,
                request_deserializer=proto.TokenPayload.from_bytes,
                response_serializer=_serialize,
            ),
        },
    )


async def start_grpc_server(host: str, port: int, *handlers) -> aio_grpc.Server:
    server = aio_grpc.server(options=channel_options())
    server.add_generic_rpc_handlers(tuple(handlers))
    if server.add_insecure_port(f"{host}:{port}") == 0:
        raise OSError(f"gRPC could not bind {host}:{port}")
    await server.start()
    log.info("gRPC listening on %s:%d", host, port)
    return server
