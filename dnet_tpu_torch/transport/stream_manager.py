"""Per-nonce bidi-stream lifecycle over gRPC aio.

Counterpart of dnet_tpu/transport/stream_manager.py: a stream opens lazily
per nonce with a background ACK reader; a backpressure ACK pauses the
stream for a backoff; a write failure drops the stream and re-sends the
frame on a fresh one under the `send_activation` retry policy
(resilience/policy.py; each re-open counts dnet_stream_reopens_total, and
the receiving shard dedups on (nonce, seq, layer_id)); idle streams are
swept.  The chaos point `send_activation` sits before each write.  An
outright refusal (a NACK that is not backpressure, e.g. the epoch fence's
`stale epoch`) goes to the `on_nack` hook, so the sender can fail the
awaiting step at once instead of waiting out its timeout.  The channel
layer is injectable, so tests pass fakes.  Each frame written counts its payload
bytes (dnet_transport_tx_bytes_total, dnet_wire_bytes_total{dir="tx"})
and itself (dnet_transport_tx_frames_total).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from dnet_tpu_torch.obs import metric
from dnet_tpu_torch.transport.protocol import ActivationFrame, StreamAck
from dnet_tpu_torch.resilience import chaos
from dnet_tpu_torch.resilience.policy import call_with_retry
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

_TX_BYTES = metric("dnet_transport_tx_bytes_total")
_TX_FRAMES = metric("dnet_transport_tx_frames_total")
_WIRE_BYTES = metric("dnet_wire_bytes_total")
_REOPENS = metric("dnet_stream_reopens_total")


@dataclass
class StreamContext:
    nonce: str
    call: object  # grpc aio stream-stream call
    ack_task: Optional[asyncio.Task] = None
    last_used: float = field(default_factory=time.monotonic)
    disabled_until: float = 0.0

    @property
    def disabled(self) -> bool:
        return time.monotonic() < self.disabled_until


class StreamManager:
    """Owns outbound activation streams keyed by nonce."""

    def __init__(
        self,
        open_stream: Callable[[], object],
        backoff_s: float = 0.25,
        idle_timeout_s: float = 30.0,
        on_nack: Optional[Callable[[StreamAck], None]] = None,
    ) -> None:
        self._open_stream = open_stream
        self._streams: Dict[str, StreamContext] = {}
        self._backoff_s = backoff_s
        self._idle_timeout_s = idle_timeout_s
        self._lock = asyncio.Lock()
        self._on_nack = on_nack  # observer of outright refusals

    async def get_or_create(self, nonce: str) -> StreamContext:
        async with self._lock:
            ctx = self._streams.get(nonce)
            if ctx is None:
                ctx = StreamContext(nonce=nonce, call=self._open_stream())
                ctx.ack_task = asyncio.ensure_future(self._ack_reader(ctx))
                self._streams[nonce] = ctx
            ctx.last_used = time.monotonic()
            return ctx

    async def send(self, nonce: str, frame: ActivationFrame) -> None:
        """Send one frame, waiting out backpressure pauses.  frame.seq is the
        caller's end-to-end step identity and is never rewritten."""

        async def _attempt() -> StreamContext:
            ctx = await self.get_or_create(nonce)
            while ctx.disabled:
                await asyncio.sleep(max(ctx.disabled_until - time.monotonic(), 0.01))
            try:
                await chaos.inject_async("send_activation")
                await ctx.call.write(frame)
            except Exception:
                # dead stream: drop it so the retry opens a fresh one
                await self.end_stream(nonce)
                raise
            return ctx

        ctx = await call_with_retry(_attempt, method="send_activation", on_retry=lambda *_: _REOPENS.inc())
        ctx.last_used = time.monotonic()
        n_bytes = len(frame.payload or b"")
        _TX_BYTES.inc(n_bytes)
        _WIRE_BYTES.labels(dir="tx").inc(n_bytes)
        _TX_FRAMES.inc()

    async def _ack_reader(self, ctx: StreamContext) -> None:
        """Consume ACKs; a backpressure ACK pauses the stream briefly."""
        try:
            while True:
                ack = await ctx.call.read()
                if ack is None or ack is getattr(ctx.call, "EOF", None):
                    break
                if isinstance(ack, (bytes, bytearray)):
                    ack = StreamAck.from_bytes(bytes(ack))
                if ack.backpressure:
                    ctx.disabled_until = time.monotonic() + self._backoff_s
                    log.warning("stream %s backpressure, pausing %.2fs", ctx.nonce, self._backoff_s)
                elif not ack.ok:
                    log.warning("stream %s NACK seq=%d: %s", ctx.nonce, ack.seq, ack.message)
                    if self._on_nack is not None:
                        try:
                            self._on_nack(ack)
                        except Exception:
                            log.exception("on_nack handler failed")
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            log.debug("ack reader for %s ended: %s", ctx.nonce, exc)

    async def end_stream(self, nonce: str) -> None:
        async with self._lock:
            ctx = self._streams.pop(nonce, None)
        if ctx is None:
            return
        if ctx.ack_task:
            ctx.ack_task.cancel()
        done = getattr(ctx.call, "done_writing", None)
        if done is not None:
            try:
                await done()
            except Exception as exc:
                log.debug("done_writing failed for %s: %s", nonce, exc)

    async def cleanup_idle(self) -> int:
        """Close streams idle past the timeout; returns the count closed."""
        now = time.monotonic()
        stale = [n for n, c in self._streams.items() if now - c.last_used > self._idle_timeout_s]
        await asyncio.gather(*(self.end_stream(n) for n in stale))
        return len(stale)

    async def shutdown(self) -> None:
        await asyncio.gather(*(self.end_stream(n) for n in list(self._streams)))
