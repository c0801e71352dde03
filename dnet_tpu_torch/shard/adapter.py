"""RingAdapter: the shard's transport glue.

Counterpart of dnet_tpu/shard/adapter.py: ingress admits a frame to local
compute when the next layer is ours (deduplicating a re-sent frame) or
relays it toward the owner; an egress task routes computed results (hidden
state -> the next shard's stream; final token -> a unary callback to the
API, and under a decode grant a continuation frame to the head first);
idle streams are swept.  The channel factories are injectable, so the
adapter runs over in-process fakes in tests.  Ingress counts a frame's
payload bytes (dnet_transport_rx_bytes_total, dnet_wire_bytes_total{dir=
"rx"}) and records `transport_recv`; egress records `shard_tx`.

Ingress is the shard's epoch fence (membership/epoch.py): a frame minted
under another topology epoch than the one this shard holds is refused
(NACK) and counted in dnet_stale_epoch_rejected_total{kind="frame"}, never
computed or relayed; the chaos point `zombie_frame` marks a frame stale on
purpose.  Token callbacks run under the `send_token` retry policy with the
chaos point `token_cb` inside the retried call; a batch frame's tail
answers with one callback a member, sent concurrently; a verify block's
tail with one callback a token it emitted, in step order, and its
continuation carries the accepted tokens (`committed`) back to the head.
A hidden hop carries the decode grant, the drafts and the prefix keys on
to the next shard.

Under the wire pipeline (DNET_WIRE_PIPELINE=1) a hidden hop whose payload
is still a launched encode is finalized on the `WireTxStage`'s thread
before its frame is built, so a re-sent frame carries the same bytes and
seq; and a queued hidden frame is decoded at ingress (the compute's
`will_predecode` / `predecode`, behind the `wire_decode` chaos point; a
failure NACKs the frame).
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from dataclasses import asdict
from typing import Callable, Dict, Optional

import numpy as np

from dnet_tpu_torch.compression.wire import codec_name
from dnet_tpu_torch.core.types import ActivationMessage
from dnet_tpu_torch.membership import epoch as epoch_fence
from dnet_tpu_torch.obs import get_recorder, metric
from dnet_tpu_torch.resilience import chaos
from dnet_tpu_torch.resilience.policy import call_with_retry
from dnet_tpu_torch.transport.protocol import ActivationFrame, TokenPayload
from dnet_tpu_torch.transport.stream_manager import StreamManager
from dnet_tpu_torch.transport.wire_pipeline import PendingWirePayload, WireTxStage
from dnet_tpu_torch.utils.logger import get_logger
from dnet_tpu_torch.utils.serialization import tensor_to_bytes

log = get_logger()

_RX_BYTES = metric("dnet_transport_rx_bytes_total")
_WIRE_BYTES = metric("dnet_wire_bytes_total")


def parse_callback(url: str) -> str:
    """grpc://host:port -> host:port."""
    return url[len("grpc://"):] if url.startswith("grpc://") else url


class RingAdapter:
    DEDUP_CAP = 4096  # admitted-frame keys kept for duplicate detection

    def __init__(
        self,
        runtime,
        ring_client_factory: Optional[Callable[[str], object]] = None,
        callback_client_factory: Optional[Callable[[str], object]] = None,
        stream_idle_s: float = 30.0,
        backoff_s: float = 0.25,
    ) -> None:
        self.runtime = runtime
        if ring_client_factory is None or callback_client_factory is None:
            from dnet_tpu_torch.transport.grpc_transport import ApiCallbackClient, RingClient

            ring_client_factory = ring_client_factory or RingClient
            callback_client_factory = callback_client_factory or ApiCallbackClient
        self._make_ring_client = ring_client_factory
        self._make_cb_client = callback_client_factory
        self.next_addr: str = ""
        self._next_client = None
        self._streams: Optional[StreamManager] = None
        self._cb_clients: Dict[str, object] = {}  # callback addr -> client
        self._tasks: list = []
        self._stream_idle_s = stream_idle_s
        self._backoff_s = backoff_s
        # a sender whose stream broke re-opens it and re-sends the in-flight
        # frame: a frame already admitted is ACKed, not computed twice
        self._seen: "OrderedDict[tuple, bool]" = OrderedDict()
        # finalizes pipelined encodes off the event loop and the compute thread
        self._wire_tx = WireTxStage()

    # ---- lifecycle ------------------------------------------------------
    async def start(self) -> None:
        self._tasks = [
            asyncio.ensure_future(self._egress_worker()),
            asyncio.ensure_future(self._idle_sweeper()),
        ]

    async def shutdown(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        self._wire_tx.shutdown()
        await self.reset_topology()

    # ---- topology -------------------------------------------------------
    def configure_topology(self, next_addr: str) -> None:
        """next_addr: 'host:grpc_port' of the next shard ('' = none)."""
        self.next_addr = next_addr
        self._next_client = None
        self._streams = None

    async def reset_topology(self) -> None:
        if self._streams:
            await self._streams.shutdown()
            self._streams = None
        if self._next_client is not None:
            await self._next_client.close()
            self._next_client = None
        await asyncio.gather(*(c.close() for c in self._cb_clients.values()), return_exceptions=True)
        self._cb_clients.clear()
        self._seen.clear()
        self.next_addr = ""

    def _ensure_next(self) -> StreamManager:
        if self._next_client is None:
            if not self.next_addr:
                raise RuntimeError("no next hop configured")
            self._next_client = self._make_ring_client(self.next_addr)
            self._streams = StreamManager(
                self._next_client.open_stream, backoff_s=self._backoff_s,
                idle_timeout_s=self._stream_idle_s,
            )
        return self._streams

    def _cb_client(self, url: str):
        addr = parse_callback(url)
        if not addr:
            return None
        client = self._cb_clients.get(addr)
        if client is None:
            client = self._cb_clients[addr] = self._make_cb_client(addr)
        return client

    # ---- ingress ----------------------------------------------------------
    async def ingress_frame(self, frame: ActivationFrame) -> tuple:
        """Admit a frame: local compute if the next layer is ours, else
        relay.  Returns (ok, message) for the ACK."""
        n_bytes = len(frame.payload or b"")
        _RX_BYTES.inc(n_bytes)
        _WIRE_BYTES.labels(dir="rx").inc(n_bytes)
        get_recorder().span(frame.nonce, "transport_recv", 0.0, bytes=n_bytes, seq=frame.seq, t_sent=frame.t_sent)
        # the epoch fence: a frame from a fenced-out sender (or one the
        # zombie_frame chaos point marks) is refused before compute or relay
        held = self.runtime.epoch
        stale = epoch_fence.is_stale(held, frame.epoch)
        try:
            await chaos.inject_async("zombie_frame")
        except chaos.ChaosError:
            stale = True
        if stale:
            err = epoch_fence.reject("frame", held, frame.epoch)
            log.warning("fenced frame %s seq=%d: %s", frame.nonce, frame.seq, err)
            return False, str(err)
        compute = self.runtime.compute
        if compute is not None and compute.wants(frame.layer_id):
            key = (frame.nonce, frame.seq, frame.layer_id)
            if key in self._seen:
                log.info("duplicate frame %s seq=%d deduped", frame.nonce, frame.seq)
                return True, "duplicate"
            msg = frame.to_message()
            if compute.will_predecode(msg, self.runtime.queue_depth):
                # the pipeline's receive half: this frame's upload and
                # dequant queue on the card now, behind the step being
                # launched (the async chaos point parks only this frame)
                try:
                    await chaos.inject_async("wire_decode")
                    compute.predecode(msg)
                except Exception as exc:
                    log.error("wire decode failed for %s seq=%d: %s", frame.nonce, frame.seq, exc)
                    return False, f"wire decode failed: {exc}"
            if not self.runtime.submit(msg, timeout=0.0 if self.runtime.queue_depth else 5.0):
                return False, "backpressure"
            self._seen[key] = True
            while len(self._seen) > self.DEDUP_CAP:
                self._seen.popitem(last=False)
            return True, ""
        try:
            await self._ensure_next().send(frame.nonce, frame)
            return True, "relayed"
        except Exception as exc:
            log.error("relay failed for %s: %s", frame.nonce, exc)
            return False, f"relay failed: {exc}"

    # ---- egress -------------------------------------------------------------
    async def _egress_worker(self) -> None:
        while True:
            out: ActivationMessage = await self.runtime.out_q.get()
            try:
                if out.is_final:
                    await self._send_token(out)
                else:
                    await self._send_activation(out)
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("egress failed for %s", out.nonce)

    async def _send_activation(self, msg: ActivationMessage) -> None:
        t0 = time.perf_counter()
        if isinstance(msg.data, PendingWirePayload):
            # a pipelined hop: the tx stage waits for the readback and packs
            # the bytes while the compute thread launches the next step; the
            # frame goes out encoded, so a stream re-open re-sends these
            # bytes with this seq
            msg.data = await self._wire_tx.finalize(msg.data, nonce=msg.nonce, seq=msg.seq)
            get_recorder().span(msg.nonce, "wire_encode", (time.perf_counter() - t0) * 1000.0, seq=msg.seq,
                                bytes=len(msg.data))
        frame = ActivationFrame(
            nonce=msg.nonce,
            seq=msg.seq,
            layer_id=msg.layer_id,
            pos=msg.pos,
            dtype=msg.dtype,
            shape=tuple(msg.shape),
            payload=msg.data if isinstance(msg.data, bytes) else bytes(msg.data),
            codec=codec_name(msg.dtype),
            callback_url=msg.callback_url,
            decoding=asdict(msg.decoding),
            t_sent=time.time(),
            t_sent_mono=t0,
            auto_steps=msg.auto_steps,
            drafts=list(msg.drafts),
            lanes=list(msg.lanes),
            prefix_store=msg.prefix_store,
            prefix_hit=msg.prefix_hit,
            deadline=msg.deadline,
            epoch=msg.epoch,
        )
        await self._ensure_next().send(msg.nonce, frame)
        get_recorder().span(msg.nonce, "shard_tx", (time.perf_counter() - t0) * 1000.0, seq=msg.seq,
                            bytes=len(frame.payload or b""))

    async def _send_token(self, msg: ActivationMessage) -> None:
        if msg.lane_finals:
            # a batch frame's tail: one callback a member (independent
            # requests, so concurrently)
            client = self._cb_client(msg.callback_url)
            if client is None:
                log.error("lane finals for %s have no callback", msg.nonce)
                return
            await asyncio.gather(*(
                self._cb_send(client, TokenPayload(
                    nonce=f["nonce"], step=int(f["step"]), token_id=int(f["token_id"]), logprob=f.get("logprob"),
                    top_ids=list(f.get("top_ids") or []), top_logprobs=list(f.get("top_logprobs") or []),
                    error=f.get("error", ""), epoch=msg.epoch))
                for f in msg.lane_finals
            ))
            return
        if msg.cont is not None:
            # decode grant: the sampled token re-enters the ring BEFORE the
            # API callback, so the next step computes while the token is in
            # flight to the API
            try:
                await self._send_continuation(msg)
            except Exception as exc:
                # the API skips sending frames for granted steps: without a
                # signal it would wait out its timeout on the next step
                log.exception("continuation injection failed for %s", msg.nonce)
                await self._send_error_token(msg, msg.cont[3], f"decode-grant continuation failed: {exc}")
        client = self._cb_client(msg.callback_url)
        if client is None:
            log.error("final token for %s has no callback", msg.nonce)
            return
        payload = TokenPayload(
            nonce=msg.nonce,
            step=msg.seq,
            token_id=int(msg.token_id if msg.token_id is not None else -1),
            logprob=msg.logprob,
            top_ids=[t for t, _ in (msg.top_logprobs or [])],
            top_logprobs=[lp for _, lp in (msg.top_logprobs or [])],
            error=msg.error,
            epoch=msg.epoch,
        )
        await self._cb_send(client, payload)
        # a verify block's further accepted tokens: one callback a step, in
        # step order behind the first (one token stream, so not concurrent)
        for step, token_id in msg.extra_finals or ():
            await self._cb_send(client, TokenPayload(nonce=msg.nonce, step=step, token_id=int(token_id),
                                                     epoch=msg.epoch))

    async def _cb_send(self, client, payload: TokenPayload):
        """One token callback under the send_token retry policy; the chaos
        point sits inside the retried call, so an injected fault is absorbed
        as a real one would be."""

        async def attempt():
            await chaos.inject_async("token_cb")
            return await client.send_token(payload)

        return await call_with_retry(attempt, method="send_token")

    async def _send_error_token(self, msg: ActivationMessage, step: int, error: str) -> None:
        client = self._cb_client(msg.callback_url)
        if client is None:
            return
        payload = TokenPayload(nonce=msg.nonce, step=step, token_id=-1, error=error, epoch=msg.epoch)
        try:
            await self._cb_send(client, payload)
        except Exception:
            log.exception("error-token delivery failed for %s", msg.nonce)

    async def _send_continuation(self, msg: ActivationMessage) -> None:
        """Inject the tail's sampled token as the nonce's next entry frame;
        the tail's next hop is the head (the ring is wired all the way
        round)."""
        token_id, pos, steps, seq = msg.cont
        payload, _dtype, shape = tensor_to_bytes(np.asarray([[token_id]], dtype=np.int32))
        frame = ActivationFrame(
            nonce=msg.nonce,
            seq=seq,
            layer_id=-1,
            pos=pos,
            dtype="tokens",
            shape=shape,
            payload=payload,
            callback_url=msg.callback_url,
            decoding=asdict(msg.decoding),
            auto_steps=steps,
            committed=list(msg.committed),
            t_sent=time.time(),
            t_sent_mono=time.perf_counter(),
            deadline=msg.deadline,
            epoch=msg.epoch,
        )
        await self._ensure_next().send(msg.nonce, frame)

    # ---- cache / sweeping ----------------------------------------------------
    async def reset_cache(self, nonce: str = "") -> None:
        if self.runtime.compute is not None:
            self.runtime.compute.reset(nonce)
        if self._streams is not None and nonce:
            await self._streams.end_stream(nonce)
        # dedup keys die with the nonce: a replayed request re-sends step 0
        if nonce:
            for key in [k for k in self._seen if k[0] == nonce]:
                del self._seen[key]
        else:
            self._seen.clear()

    async def _idle_sweeper(self) -> None:
        while True:
            await asyncio.sleep(self._stream_idle_s)
            if self._streams is not None:
                await self._streams.cleanup_idle()
