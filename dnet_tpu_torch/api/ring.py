"""Ring strategy on the API node: token frames out to the head shard, the
sampled tokens back through the API's gRPC servicer.

Counterpart of dnet_tpu/api/ring.py `RingApiAdapter` and `ApiTokenServicer`.
A token callback minted under another
topology epoch than the adapter's (a fenced-out shard finishing old work)
is dropped and counted in dnet_stale_epoch_rejected_total{kind="token_cb"};
a shard's `stale epoch` NACK of one of this adapter's frames fails the
awaiting step at once (`_on_stream_nack`), so a request whose topology
changed under it resumes on the new adapter instead of waiting out its
timeout.
Decode grants: a frame may let the tail feed up to `auto_steps` sampled
tokens straight back to the head, so those steps send no frame from here;
their tokens may arrive before the decode loop awaits them and wait in
`_early`.  Batched lanes (lanes > 1, DNET_API_RING_LANES): concurrent
requests' decode steps coalesce into multi-lane frames on the carrier
stream `LANES_NONCE` (`_flush_lanes`), which each shard serves with one
batched step (shard/lanes.py); grants are off then.  A batch holds open
for more members up to an adaptive convergence window (2.5 ring passes,
0.05-1 s), and a member whose deadline passed is shed at the flush
(dnet_deadline_exceeded_total{stage="lane_flush"}); each flush observes
dnet_lane_flush_depth and each member dnet_lane_queue_wait_ms, and each
resolved frame dnet_ring_hop_rtt_ms.

The ring prefix cache (`prefix_cache` entries, DNET_API_PREFIX_CACHE):
this node alone sees token ids, so it matches prompts in a `PrefixIndex`
whose values are snapshot keys (the sha1 of the prompt, as the
reference's) and sends them in step-0 frames: `prefix_store` asks every
shard to snapshot its window after the prompt, `prefix_hit` sends only
the suffix at pos = the prefix length (a `prefix_cache_hit` span).  A
shard that holds no such snapshot answers `prefix-miss:<key>`; the index
is cleared and, once a request, the whole prompt is sent again after a
reset of the nonce on every shard (`_refill_prefill`, a `prefix_refill`
span, dnet_prefix_refill_total).  As in the reference, a key is indexed
when its frame is sent, before any shard has stored it: a request that
extends a prompt still in flight may hit that key and miss at a shard,
and the refill is what answers it.
"""

from __future__ import annotations

import asyncio
import hashlib
import time
from dataclasses import asdict
from typing import Callable, Dict, List, Optional

import numpy as np

from dnet_tpu_torch.admission.controller import deadline_expired
from dnet_tpu_torch.api.strategies import ApiAdapterBase, _TokenFutures
from dnet_tpu_torch.core.prefix_cache import PrefixIndex
from dnet_tpu_torch.core.types import DecodingParams, TokenResult
from dnet_tpu_torch.membership import epoch as epoch_fence
from dnet_tpu_torch.obs import get_recorder, metric
from dnet_tpu_torch.transport.protocol import ActivationFrame, Empty, TokenPayload
from dnet_tpu_torch.transport.stream_manager import StreamManager
from dnet_tpu_torch.utils.logger import get_logger
from dnet_tpu_torch.utils.serialization import tensor_to_bytes

log = get_logger()

_HOP_RTT_MS = metric("dnet_ring_hop_rtt_ms")
_LANE_DEPTH = metric("dnet_lane_flush_depth")
_LANE_WAIT_MS = metric("dnet_lane_queue_wait_ms")
_PREFIX_REFILL = metric("dnet_prefix_refill_total")


class RingApiAdapter(ApiAdapterBase):
    LANES_NONCE = "__lanes__"  # carrier stream of coalesced decode frames
    # bounds of the window a partly filled batch holds open for more
    # mid-decode members: a convergence cost (members of one batch resolve
    # and re-send together), scaled by the observed ring pass (the EMA is
    # stamped at the flush, so it holds no batch's own wait)
    LANE_CONVERGE_MIN_S = 0.05
    LANE_CONVERGE_MAX_S = 1.0
    LANE_CONVERGE_EMA_MULT = 2.5
    PREFIX_MIN_TOKENS = 16  # shorter prompts are not worth a snapshot

    def __init__(
        self,
        head_addr: str,
        callback_url: str,
        shard_grpc_addrs: Optional[List[str]] = None,
        ring_client_factory: Optional[Callable[[str], object]] = None,
        max_seq_len: Optional[int] = None,
        stream_idle_s: float = 300.0,
        auto_steps: int = 0,
        lanes: int = 1,
        prefix_cache: int = 0,
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
        # lanes > 1: decode steps coalesce; a grant would pull its request
        # out of the batches' shared cadence, so grants are off
        self._lanes = max(int(lanes), 1)
        self._auto_steps = 0 if self._lanes > 1 else max(int(auto_steps), 0)
        self._granted: Dict[str, int] = {}  # nonce -> highest granted step
        self._early: Dict[tuple, TokenResult] = {}
        self._pending: List[dict] = []  # lane entries awaiting a flush
        self._flush_task: Optional[asyncio.Task] = None
        self._batch_seq = 0
        self._step_ema = 0.0  # send -> resolve EMA (s), sizes the lane window
        self._sent_at: Dict[tuple, float] = {}  # (nonce, step) -> flush time
        self._active: Dict[str, bool] = {}  # nonces mid-decode (first lane send -> reset)
        # nonce -> absolute wall-clock deadline (epoch s), stamped into every
        # frame of the request: the shards drop expired frames at dequeue
        self._deadlines: Dict[str, float] = {}
        # the ring prefix cache: prompts -> snapshot keys, the same capacity
        # as each shard's store; while a suffix-only prefill is in flight the
        # whole prompt waits in `_refill_state` for a shard's prefix-miss
        self._prefix_cap = max(int(prefix_cache), 0)
        self._prefix_index = PrefixIndex(max(self._prefix_cap, 1), self.PREFIX_MIN_TOKENS)
        self._refill_state: Dict[str, dict] = {}
        self._refill_tasks: set = set()  # strong references to running refills

    async def start(self) -> None:
        self._head_client = self._make_client(self.head_addr)
        self._streams = StreamManager(self._head_client.open_stream, idle_timeout_s=self._stream_idle_s,
                                      on_nack=self._on_stream_nack)
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

    def _on_stream_nack(self, ack) -> None:
        """A shard refused one of this adapter's frames outright: on a
        `stale epoch` refusal (its topology was re-solved under it) the
        token can never come, so the awaiting step fails now and the resume
        controller can replay on the new adapter.  The lanes carrier has no
        future of its own, and other refusals keep their timeout."""
        if ack.nonce == self.LANES_NONCE or not str(ack.message).startswith("stale epoch"):
            return
        self.resolve_token(TokenResult(nonce=ack.nonce, token_id=-1, step=ack.seq,
                                       error=f"frame rejected: {ack.message}"))

    async def reset_cache(self, nonce: str) -> None:
        """Drop the nonce's state here and its KV on every shard."""
        self._futures.cancel_nonce(nonce)
        self._pos_state.pop(nonce, None)
        self._granted.pop(nonce, None)
        self._deadlines.pop(nonce, None)
        self._active.pop(nonce, None)
        self._refill_state.pop(nonce, None)
        if self._pending:
            self._pending = [e for e in self._pending if e["nonce"] != nonce]
        for table in (self._early, self._sent_at):
            for key in [k for k in table if k[0] == nonce]:
                table.pop(key, None)
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
        if self._lanes > 1 and step > 0:
            # a decode step joins the next multi-lane frame; a prefill never
            # counts toward the batch target (it would hold every flush open)
            self._active[nonce] = True
            self._pending.append({"nonce": nonce, "seq": step, "pos": pos, "decoding": asdict(decoding),
                                  "token": int(token_ids[0]), "t_enq": time.monotonic()})
            if self._flush_task is None or self._flush_task.done():
                self._flush_task = asyncio.ensure_future(self._flush_lanes())
            return
        send_ids, prefix_hit, prefix_store = token_ids, "", ""
        if step == 0 and self._prefix_cap > 0:
            ids = tuple(token_ids)
            hit = self._prefix_lookup(ids)
            if hit is not None:
                pos, prefix_hit = hit
                get_recorder().span(nonce, "prefix_cache_hit", 0.0, tokens=pos)
                send_ids = token_ids[pos:]  # only the new suffix prefills
                # a shard's prefix-miss re-sends the whole prompt
                self._refill_state[nonce] = {"token_ids": list(token_ids), "decoding": decoding, "budget": budget}
            if len(ids) >= self.PREFIX_MIN_TOKENS:
                prefix_store = self._prefix_put(ids)
        await self._send_token_frame(nonce, send_ids, pos, decoding, step, budget,
                                     prefix_hit=prefix_hit, prefix_store=prefix_store)

    async def _send_token_frame(
        self, nonce: str, send_ids: List[int], pos: int, decoding: DecodingParams, step: int,
        budget: Optional[int], prefix_hit: str = "", prefix_store: str = "",
    ) -> None:
        """One token frame, with its decode grant sized from the remaining
        budget (and registered here), and the prefix keys of a step 0: the
        one frame path of a send and of a prefix refill."""
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
            prefix_hit=prefix_hit,
            prefix_store=prefix_store,
            epoch=self._epoch,
            deadline=self._deadlines.get(nonce, 0.0),
        )
        if auto:
            self._granted[nonce] = step + auto
        await self._streams.send(nonce, frame)

    def _converge_window(self) -> float:
        ema = self._step_ema
        if ema <= 0:
            return self.LANE_CONVERGE_MIN_S
        return min(max(self.LANE_CONVERGE_EMA_MULT * ema, self.LANE_CONVERGE_MIN_S), self.LANE_CONVERGE_MAX_S)

    async def _flush_lanes(self) -> None:
        """Drain the pending lane entries into multi-lane frames, holding a
        partly filled batch open (up to the convergence window) while more
        mid-decode requests could join.  A request never sends step k + 1
        before step k resolved, so each nonce appears once a batch."""
        await asyncio.sleep(0)
        loop = asyncio.get_running_loop()
        while self._pending:
            target = min(self._lanes, len(self._active))
            if len(self._pending) < target:
                deadline = loop.time() + self._converge_window()
                while len(self._pending) < target and loop.time() < deadline:
                    await asyncio.sleep(0.0005)
            batch, self._pending = self._pending[: self._lanes], self._pending[self._lanes:]
            # shed expired members here: one late member must not expire the
            # whole frame at a shard and fail its live batchmates
            live = []
            for e in batch:
                dl = self._deadlines.get(e["nonce"], 0.0)
                if dl and time.time() >= dl:
                    deadline_expired("lane_flush")
                    self.resolve_token(TokenResult(nonce=e["nonce"], token_id=-1, step=e["seq"],
                                                   error="deadline exceeded at lane flush"))
                else:
                    live.append(e)
            if not live:
                continue
            _LANE_DEPTH.observe(len(live))
            now = time.monotonic()
            for e in live:
                wait_ms = (now - e["t_enq"]) * 1000
                _LANE_WAIT_MS.observe(wait_ms)
                get_recorder().span(e["nonce"], "lane_queue_wait", wait_ms, step=e["seq"])
                # the hop RTT (and the window's EMA) measures the ring pass
                # alone: stamped at the flush, not at the enqueue
                self._sent_at[(e["nonce"], e["seq"])] = now
            payload, _dtype, shape = tensor_to_bytes(np.asarray([[e["token"]] for e in live], dtype=np.int32))
            frame = ActivationFrame(
                nonce=self.LANES_NONCE,
                seq=self._batch_seq,
                layer_id=-1,
                pos=0,
                dtype="tokens",
                shape=shape,
                payload=payload,
                callback_url=self.callback_url,
                decoding={},
                t_sent=time.time(),
                t_sent_mono=time.perf_counter(),
                lanes=[{k: e[k] for k in ("nonce", "seq", "pos", "decoding")} for e in live],
                epoch=self._epoch,
            )
            self._batch_seq += 1
            log.info("[PROFILE] lane flush: %d member(s), %d active, %d still pending",
                     len(live), len(self._active), len(self._pending))
            try:
                await self._streams.send(self.LANES_NONCE, frame)
            except Exception as exc:
                # every member fails alone and fast (a failed send is not a
                # hop: its stamp must not feed the EMA)
                for e in live:
                    self._sent_at.pop((e["nonce"], e["seq"]), None)
                    self.resolve_token(TokenResult(nonce=e["nonce"], token_id=-1, step=e["seq"],
                                                   error=f"batch frame send failed: {exc}"))

    def _prefix_lookup(self, ids: tuple):
        """The longest indexed strict prefix of `ids` (PrefixIndex's rules,
        counted there): (n_tokens, key) or None."""
        return self._prefix_index.lookup(ids)

    def _prefix_put(self, ids: tuple) -> str:
        """Index the whole prompt and return its key, under which every
        shard snapshots its window as the prompt frame passes."""
        key = self._prefix_index.get_exact(ids)
        if key is None:
            key = hashlib.sha1(np.asarray(ids, dtype=np.int64).tobytes()).hexdigest()[:16]
            self._prefix_index.put(ids, key)
        return key

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
        sent = self._sent_at.pop((result.nonce, result.step), None)
        if sent is not None:
            dt = time.monotonic() - sent
            _HOP_RTT_MS.observe(dt * 1000)
            get_recorder().span(result.nonce, "hop_rtt", dt * 1000, step=result.step)
            self._step_ema = dt if self._step_ema <= 0 else 0.8 * self._step_ema + 0.2 * dt
        if result.error and result.error.startswith("prefix-miss:"):
            # a shard that lost one snapshot (a restart, a full reset) lost
            # them all: clear the whole index, and re-send this request's
            # whole prompt once; a second miss, with no stash left, fails
            self._prefix_index.clear()
            state = self._refill_state.pop(result.nonce, None)
            if state is not None and result.step == 0:
                try:
                    task = asyncio.ensure_future(self._refill_prefill(result.nonce, state))
                except RuntimeError:  # no running loop: surface the error
                    log.warning("prefix refill skipped: no event loop")
                else:
                    self._refill_tasks.add(task)
                    task.add_done_callback(self._refill_tasks.discard)
                    _PREFIX_REFILL.inc()
                    log.warning("prefix refill for %s: %s", result.nonce, result.error)
                    return  # the step-0 future waits for the refill
        elif result.step == 0:
            self._refill_state.pop(result.nonce, None)  # the suffix prefill answered
        if not self._futures.resolve(result):
            if result.step <= self._granted.get(result.nonce, -1):
                # a granted step raced ahead of the decode loop's await: hold it
                # until send_tokens registers the future
                self._early[(result.nonce, result.step)] = result
                return
            log.warning("unmatched token for nonce %s step %d", result.nonce, result.step)

    async def _refill_prefill(self, nonce: str, state: dict) -> None:
        """Step 0 again as a whole-prompt prefill after a shard's
        prefix-miss: the nonce is reset on every shard first (a shard that
        seeded its session at the prefix length must not extend it from pos
        0), then the stashed prompt goes out on the one frame path,
        re-indexed so that every shard stores it again.  A failure answers
        the waiting step 0 with an error."""
        try:
            token_ids = state["token_ids"]
            await asyncio.gather(*(c.reset_cache(nonce, epoch=self._epoch) for c in self._shard_clients.values()),
                                 return_exceptions=True)
            pos = self._pos_for(nonce, 0, len(token_ids))
            prefix_store = ""
            if self._prefix_cap > 0 and len(token_ids) >= self.PREFIX_MIN_TOKENS:
                prefix_store = self._prefix_put(tuple(token_ids))
            get_recorder().span(nonce, "prefix_refill", 0.0, tokens=len(token_ids))
            await self._send_token_frame(nonce, token_ids, pos, state["decoding"], 0, state["budget"],
                                         prefix_store=prefix_store)
        except Exception as exc:
            log.exception("prefix refill for %s failed", nonce)
            self._futures.resolve(TokenResult(nonce=nonce, token_id=-1, step=0, error=f"prefix refill failed: {exc}"))

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
