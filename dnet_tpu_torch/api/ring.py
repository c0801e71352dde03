"""Ring strategy on the API node: token frames out to the head shard, the
sampled tokens back through the API's gRPC servicer.

Counterpart of dnet_tpu/api/ring.py `RingApiAdapter` and `ApiTokenServicer`
without lane coalescing, the ring prefix cache and epoch NACK handling.
A token callback minted under another topology epoch than the adapter's
(a fenced-out shard finishing old work) is dropped and counted in
dnet_stale_epoch_rejected_total{kind="token_cb"}.
Decode grants are kept: a frame may let the tail feed up to `auto_steps`
sampled tokens straight back to the head, so those steps send no frame
from here; their tokens may arrive before the decode loop awaits them and wait
in `_early`.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import asdict
from typing import Callable, Dict, List, Optional

import numpy as np

from dnet_tpu_torch.api.strategies import ApiAdapterBase, _TokenFutures
from dnet_tpu_torch.core.types import DecodingParams, TokenResult
from dnet_tpu_torch.membership import epoch as epoch_fence
from dnet_tpu_torch.transport.protocol import ActivationFrame, Empty, TokenPayload
from dnet_tpu_torch.transport.stream_manager import StreamManager
from dnet_tpu_torch.utils.logger import get_logger
from dnet_tpu_torch.utils.serialization import tensor_to_bytes

log = get_logger()


class RingApiAdapter(ApiAdapterBase):
    def __init__(
        self,
        head_addr: str,
        callback_url: str,
        shard_grpc_addrs: Optional[List[str]] = None,
        ring_client_factory: Optional[Callable[[str], object]] = None,
        max_seq_len: Optional[int] = None,
        stream_idle_s: float = 300.0,
        auto_steps: int = 0,
        epoch: int = 0,
    ) -> None:
        if ring_client_factory is None:
            from dnet_tpu_torch.transport.grpc_transport import RingClient

            ring_client_factory = RingClient
        self.head_addr = head_addr
        self.callback_url = callback_url
        self.shard_addrs = shard_grpc_addrs or [head_addr]
        self._make_client = ring_client_factory
        self._epoch = int(epoch)  # stamped on every frame and reset
        self._head_client = None
        self._streams: Optional[StreamManager] = None
        self._shard_clients: Dict[str, object] = {}
        self._futures = _TokenFutures()
        self._max_seq = max_seq_len
        self._stream_idle_s = stream_idle_s
        self._sweeper: Optional[asyncio.Task] = None
        self._pos_state: Dict[str, int] = {}  # nonce -> prompt length
        self._auto_steps = max(int(auto_steps), 0)
        self._granted: Dict[str, int] = {}  # nonce -> highest granted step
        self._early: Dict[tuple, TokenResult] = {}
        # nonce -> absolute wall-clock deadline (epoch s), stamped into every
        # frame of the request: the shards drop expired frames at dequeue
        self._deadlines: Dict[str, float] = {}

    async def start(self) -> None:
        self._head_client = self._make_client(self.head_addr)
        self._streams = StreamManager(self._head_client.open_stream, idle_timeout_s=self._stream_idle_s)
        # persistent control channels: a reset per request must not pay a
        # channel handshake per shard
        self._shard_clients = {addr: self._make_client(addr) for addr in self.shard_addrs}
        self._sweeper = asyncio.ensure_future(self._idle_sweep())

    async def shutdown(self) -> None:
        if self._sweeper:
            self._sweeper.cancel()
            self._sweeper = None
        if self._streams:
            await self._streams.shutdown()
            self._streams = None
        outcomes = await asyncio.gather(
            *(c.close() for c in self._shard_clients.values()), return_exceptions=True
        )
        self._shard_clients = {}
        if self._head_client is not None:
            await self._head_client.close()
            self._head_client = None
        for exc in outcomes:
            if isinstance(exc, Exception):
                raise exc

    def max_seq(self) -> Optional[int]:
        return self._max_seq

    async def reset_cache(self, nonce: str) -> None:
        """Drop the nonce's state here and its KV on every shard."""
        self._futures.cancel_nonce(nonce)
        self._pos_state.pop(nonce, None)
        self._granted.pop(nonce, None)
        self._deadlines.pop(nonce, None)
        for key in [k for k in self._early if k[0] == nonce]:
            self._early.pop(key, None)
        if self._streams is not None:
            await self._streams.end_stream(nonce)

        async def _reset(addr: str, client) -> None:
            try:
                await client.reset_cache(nonce, epoch=self._epoch)
            except Exception as exc:
                log.warning("reset_cache on %s failed: %s", addr, exc)

        await asyncio.gather(*(_reset(a, c) for a, c in self._shard_clients.items()))

    def set_deadline(self, nonce: str, deadline_ts: float) -> None:
        if deadline_ts > 0:
            self._deadlines[nonce] = float(deadline_ts)

    async def send_tokens(
        self,
        nonce: str,
        token_ids: List[int],
        decoding: DecodingParams,
        step: int,
        budget: Optional[int] = None,
    ) -> None:
        if self._streams is None:
            raise RuntimeError("adapter not started")
        self._futures.expect(nonce, step)
        if 0 < step <= self._granted.get(nonce, -1):
            # the ring itself produces this step's token (decode grant): no
            # frame; resolve now if it already arrived
            early = self._early.pop((nonce, step), None)
            if early is not None:
                self._futures.resolve(early)
            return
        pos = self._pos_for(nonce, step, len(token_ids))
        await self._send_token_frame(nonce, token_ids, pos, decoding, step, budget)

    async def _send_token_frame(
        self, nonce: str, send_ids: List[int], pos: int, decoding: DecodingParams, step: int,
        budget: Optional[int],
    ) -> None:
        """One token frame, with its decode grant sized from the remaining
        budget (and registered here)."""
        auto = 0
        if self._auto_steps > 0 and budget is not None and budget > 1:
            auto = min(self._auto_steps, budget - 1)
        payload, _dtype, shape = tensor_to_bytes(np.asarray([send_ids], dtype=np.int32))
        frame = ActivationFrame(
            nonce=nonce,
            seq=step,
            layer_id=-1,
            pos=pos,
            dtype="tokens",
            shape=shape,
            payload=payload,
            callback_url=self.callback_url,
            decoding=asdict(decoding),
            t_sent=time.time(),
            t_sent_mono=time.perf_counter(),
            auto_steps=auto,
            epoch=self._epoch,
            deadline=self._deadlines.get(nonce, 0.0),
        )
        if auto:
            self._granted[nonce] = step + auto
        await self._streams.send(nonce, frame)

    def _pos_for(self, nonce: str, step: int, n_tokens: int) -> int:
        """Step 0 injects the whole prompt at pos 0; every later step
        appends one token, so pos is derived (prompt length + step - 1)
        rather than counted, and a grant that halts early cannot skew it."""
        if step == 0:
            self._pos_state[nonce] = n_tokens
            return 0
        if n_tokens != 1:
            raise ValueError("post-prompt frames carry exactly one token")
        return self._pos_state.get(nonce, 0) + step - 1

    async def await_token(self, nonce: str, step: int, timeout: float) -> TokenResult:
        return await self._futures.wait(nonce, step, timeout)

    def resolve_token(self, result: TokenResult) -> None:
        if epoch_fence.is_stale(self._epoch, result.epoch):
            err = epoch_fence.reject("token_cb", self._epoch, result.epoch)
            log.warning("zombie token for %s step %d dropped: %s", result.nonce, result.step, err)
            return
        if not self._futures.resolve(result):
            if result.step <= self._granted.get(result.nonce, -1):
                # a granted step raced ahead of the decode loop's await: hold it
                # until send_tokens registers the future
                self._early[(result.nonce, result.step)] = result
                return
            log.warning("unmatched token for nonce %s step %d", result.nonce, result.step)

    async def _idle_sweep(self) -> None:
        while True:
            await asyncio.sleep(self._stream_idle_s)
            if self._streams is not None:
                await self._streams.cleanup_idle()


class ApiTokenServicer:
    """gRPC ShardApi service: receives the sampled token from the tail."""

    def __init__(self, resolve: Callable[[TokenResult], None]) -> None:
        self._resolve = resolve

    async def send_token(self, payload: TokenPayload, context) -> Empty:
        self._resolve(payload.to_result())
        return Empty()
