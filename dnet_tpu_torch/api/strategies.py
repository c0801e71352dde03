"""Execution-strategy seam: how the decode driver reaches the engine.

Counterpart of dnet_tpu/api/strategies.py: `ApiAdapterBase` is the
contract the driver speaks; `LocalAdapter` runs the engine in this process
on one compute thread, chunking decode steps with the same 2 -> 4 -> ...
width ramp and the same one-chunk-ahead pipelining as the reference.
"""

from __future__ import annotations

import abc
import asyncio
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from dnet_tpu_torch.core.types import DecodingParams, TokenResult
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

# bound on awaiting a cancelled background task at shutdown: a step wedged
# in run_in_executor must not hang the shutdown
_REAP_TIMEOUT_S = 5.0


async def _reap(task: Optional["asyncio.Task"], what: str) -> None:
    """Cancel and await a background task, bounded."""
    if not task:
        return
    task.cancel()
    try:
        await asyncio.wait_for(task, timeout=_REAP_TIMEOUT_S)
    except (asyncio.CancelledError, asyncio.TimeoutError):
        pass
    if not task.done():
        log.warning("%s ignored cancellation for %.0fs at shutdown; abandoning it", what, _REAP_TIMEOUT_S)


class ApiAdapterBase(abc.ABC):
    """Token-path adapter between the decode driver and the compute."""

    @abc.abstractmethod
    async def start(self) -> None: ...

    @abc.abstractmethod
    async def shutdown(self) -> None: ...

    @abc.abstractmethod
    async def reset_cache(self, nonce: str) -> None:
        """Drop per-nonce state (KV)."""

    @abc.abstractmethod
    async def send_tokens(
        self,
        nonce: str,
        token_ids: List[int],
        decoding: DecodingParams,
        step: int,
        budget: Optional[int] = None,
    ) -> None:
        """Inject tokens for one decode step (whole prompt on step 0).
        `budget` is the request's remaining token allowance, which lets the
        adapter fuse several steps without overshooting max_tokens."""

    @abc.abstractmethod
    async def await_token(self, nonce: str, step: int, timeout: float) -> TokenResult:
        """Wait for the sampled token of one step."""

    def max_seq(self) -> Optional[int]:
        """Sequence capacity of the serving path, when known."""
        return None


class _TokenFutures:
    """Per-nonce, step-keyed futures: a late token from a timed-out step can
    never be delivered to a later step.  resolve() may be called from any
    thread; the awaiting side pops."""

    def __init__(self) -> None:
        self._futures: Dict[tuple, asyncio.Future] = {}

    def expect(self, nonce: str, step: int) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._futures[(nonce, step)] = fut
        return fut

    def resolve(self, result: TokenResult) -> bool:
        fut = self._futures.get((result.nonce, result.step))
        if fut is None or fut.done():
            return False
        fut.get_loop().call_soon_threadsafe(lambda: fut.done() or fut.set_result(result))
        return True

    async def wait(self, nonce: str, step: int, timeout: float) -> TokenResult:
        fut = self._futures.get((nonce, step))
        if fut is None:
            raise RuntimeError(f"no pending token for nonce {nonce} step {step}")
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._futures.pop((nonce, step), None)

    def cancel_nonce(self, nonce: str) -> None:
        for key in [k for k in self._futures if k[0] == nonce]:
            fut = self._futures.pop(key)
            if not fut.done():
                fut.cancel()


class LocalAdapter(ApiAdapterBase):
    """Single-process strategy: the engine runs on a dedicated one-thread
    executor, so the event loop never waits on the device.

    Decode steps are chunked: one engine call enqueues up to `chunk_size`
    steps and the extra tokens are buffered here, resolving later
    send_tokens calls at once.  Chunk width ramps 2 -> 4 -> ... ->
    chunk_size per request, so streaming clients see early tokens at
    per-token latency while long generations converge to chunked rate.
    """

    MAX_BUFFERED_NONCES = 64  # aborted-mid-chunk leftovers cap (leak bound)
    SWEEP_INTERVAL_S = 60.0

    def __init__(self, engine, chunk_size: int = 32) -> None:
        self.engine = engine
        self.chunk_size = max(1, chunk_size)
        self._futures = _TokenFutures()
        self._executor: Optional[ThreadPoolExecutor] = None
        self._sweep_task: Optional[asyncio.Task] = None
        # compute thread inserts, event loop consumes/clears
        self._buf_lock = threading.Lock()
        self._buffered: Dict[str, Dict[int, TokenResult]] = {}
        self._ramp: Dict[str, int] = {}  # nonce -> next chunk width

    async def start(self) -> None:
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="compute")
        self._sweep_task = asyncio.ensure_future(self._sweep_loop())

    async def _sweep_loop(self) -> None:
        """Periodic TTL sweep on the compute thread: a client that vanished
        without reset_cache must not pin its KV forever."""
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.SWEEP_INTERVAL_S)
            if self._executor is None:
                return
            try:
                n = await loop.run_in_executor(self._executor, self.engine.sweep_sessions)
                if n:
                    log.info("TTL sweep freed %d idle sessions", n)
            except Exception:
                log.exception("session sweep failed")

    async def shutdown(self) -> None:
        sweep, self._sweep_task = self._sweep_task, None
        await _reap(sweep, "session sweep")
        if self._executor:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None

    async def reset_cache(self, nonce: str) -> None:
        self.engine.end_session(nonce)
        self._futures.cancel_nonce(nonce)
        with self._buf_lock:
            self._buffered.pop(nonce, None)
            self._ramp.pop(nonce, None)

    def max_seq(self) -> Optional[int]:
        return self.engine.max_seq

    async def send_tokens(
        self,
        nonce: str,
        token_ids: List[int],
        decoding: DecodingParams,
        step: int,
        budget: Optional[int] = None,
    ) -> None:
        if self._executor is None:
            raise RuntimeError("adapter not started")
        self._futures.expect(nonce, step)
        with self._buf_lock:
            entries = self._buffered.get(nonce)
            buffered = entries.pop(step, None) if entries else None
            if entries is not None and not entries:
                del self._buffered[nonce]
        if buffered is not None:
            self._futures.resolve(buffered)
            return
        asyncio.get_running_loop().run_in_executor(
            self._executor, self._compute_step, nonce, list(token_ids), decoding, step, budget,
        )

    def _next_chunk_width(self, nonce: str, budget: Optional[int]) -> int:
        with self._buf_lock:
            width = self._ramp.get(nonce, min(2, self.chunk_size))
            self._ramp[nonce] = min(width * 2, self.chunk_size)
            if len(self._ramp) > self.MAX_BUFFERED_NONCES:
                live = self.engine.sessions
                for n in [n for n in self._ramp if n not in live]:
                    del self._ramp[n]
        # no budget => no chunking: a chunk must never overshoot max_tokens
        return min(width, budget) if budget is not None else 1

    def _chunked_results(self, eng, nonce: str, token_ids: List[int], decoding, budget):
        """Pipelined chunked decode: read the current chunk AFTER enqueueing
        the next one, so the read overlaps the device computing ahead.
        Returns the current chunk's results, or None for a single step."""
        if eng.pending_chunks(nonce) == 0:
            chunk = self._next_chunk_width(nonce, budget)
            if chunk <= 1:
                return None
            if eng.decode_chunk_dispatch(nonce, token_ids[-1], decoding, chunk) == 0:
                return None
        # one chunk beyond the unread one: EOS overshoot wastes at most that
        # chunk's compute (its KV rows die with the session)
        if budget is not None and budget - eng.pending_width(nonce) > 1:
            nxt = self._next_chunk_width(nonce, budget - eng.pending_width(nonce))
            if nxt > 1:
                eng.decode_chunk_dispatch(nonce, None, decoding, nxt)
        return eng.decode_chunk_read(nonce)

    def _buffer_results(self, nonce: str, entries: Dict[int, TokenResult]) -> None:
        with self._buf_lock:
            self._buffered[nonce] = entries
            if len(self._buffered) > self.MAX_BUFFERED_NONCES:
                # only leftovers of aborted requests (session ended) go
                live = self.engine.sessions
                for n in [n for n in self._buffered if n not in live]:
                    if len(self._buffered) <= self.MAX_BUFFERED_NONCES:
                        break
                    del self._buffered[n]

    def _compute_step(
        self,
        nonce: str,
        token_ids: List[int],
        decoding: DecodingParams,
        step: int,
        budget: Optional[int] = None,
    ) -> None:
        try:
            eng = self.engine
            if step == 0:
                res = eng.prefill_and_sample(nonce, token_ids, decoding)
            elif nonce not in eng.sessions:
                # re-prefilling from the last token would silently continue
                # with an empty context
                raise RuntimeError(f"session expired for request {nonce}")
            else:
                results = self._chunked_results(eng, nonce, token_ids, decoding, budget)
                if results is None:
                    res = eng.decode_step(nonce, token_ids[-1], decoding)
                else:
                    if len(results) > 1:
                        self._buffer_results(
                            nonce,
                            {
                                step + i: eng.token_result(nonce, r, step=step + i, decoding=decoding)
                                for i, r in enumerate(results[1:], start=1)
                            },
                        )
                    res = results[0]
            self._futures.resolve(eng.token_result(nonce, res, step=step, decoding=decoding))
        except Exception as exc:  # surfaced to await_token as an error result
            log.exception("local compute step failed")
            self._futures.resolve(TokenResult(nonce=nonce, token_id=-1, error=str(exc), step=step))

    async def await_token(self, nonce: str, step: int, timeout: float) -> TokenResult:
        return await self._futures.wait(nonce, step, timeout)
