"""Execution-strategy seam: how the decode driver reaches the engine.

Counterpart of dnet_tpu/api/strategies.py: `ApiAdapterBase` is the
contract the driver speaks; `LocalAdapter` runs the engine in this process
on one compute thread, chunking decode steps with the same 2 -> 4 -> ...
width ramp and the same one-chunk-ahead pipelining as the reference;
`BatchedLocalAdapter` coalesces concurrent requests' decode steps into one
batched engine call (continuous batching).  DNET_SCHED=1 serves the
iteration-level scheduler's adapter instead (sched/engine.py).
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


async def _sweep_loop(adapter, interval_s: float = 60.0) -> None:
    """Periodic TTL sweep on the adapter's compute thread: a client that
    vanished without reset_cache must not pin its KV or slot forever."""
    loop = asyncio.get_running_loop()
    while True:
        await asyncio.sleep(interval_s)
        if adapter._executor is None:
            return
        try:
            n = await loop.run_in_executor(adapter._executor, adapter.engine.sweep_sessions)
            if n:
                log.info("TTL sweep freed %d idle sessions", n)
        except Exception:
            log.exception("session sweep failed")


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

    def set_deadline(self, nonce: str, deadline_ts: float) -> None:
        """Register the request's absolute wall-clock deadline (epoch
        seconds).  In-process adapters have no frames to stamp: the decode
        loop checks it between steps."""


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

    def fail_all(self, error: str) -> None:
        """Resolve every pending future with an error TokenResult (the
        awaiting side still owns the pop)."""
        for nonce, step in list(self._futures):
            self.resolve(TokenResult(nonce=nonce, token_id=-1, step=step, error=error))


class BatchedLocalAdapter(ApiAdapterBase):
    """Continuous-batching strategy over a BatchedEngine (core/batch.py).

    Decode steps from concurrent requests coalesce: send_tokens enqueues the
    step and a loop task drains everything pending into ONE batched engine
    call.  While a batched step runs on the compute thread, newly arriving
    steps queue for the next round.  Prompts prefill in chunks of
    PREFILL_CHUNK tokens, one executor job each, so queued batched steps run
    between a long prompt's chunks.  One compute thread: no KV races."""

    PREFILL_CHUNK = 256  # prompt tokens per executor job (interleave grain)

    def __init__(self, engine) -> None:
        self.engine = engine  # BatchedEngine
        self._futures = _TokenFutures()
        self._executor: Optional[ThreadPoolExecutor] = None
        self._pending: Dict[str, tuple] = {}  # nonce -> (token, decoding, step, budget)
        self._kick: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._sweep_task: Optional[asyncio.Task] = None
        self._prefill_tasks: set = set()

    async def start(self) -> None:
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="compute")
        self._kick = asyncio.Event()
        self._task = asyncio.ensure_future(self._batch_loop())
        self._sweep_task = asyncio.ensure_future(_sweep_loop(self))

    async def shutdown(self) -> None:
        task, self._task = self._task, None
        await _reap(task, "batch loop")
        sweep, self._sweep_task = self._sweep_task, None
        await _reap(sweep, "session sweep")
        for t in list(self._prefill_tasks):
            t.cancel()
        self._prefill_tasks.clear()
        if self._executor:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None

    async def reset_cache(self, nonce: str) -> None:
        self._pending.pop(nonce, None)
        # slot state belongs to the compute thread: freeing it from the event
        # loop would race an in-flight batched step
        if self._executor is not None:
            await asyncio.get_running_loop().run_in_executor(
                self._executor, self.engine.end_session, nonce
            )
        self._futures.cancel_nonce(nonce)

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
        if self._executor is None or self._kick is None:
            raise RuntimeError("adapter not started")
        self._futures.expect(nonce, step)
        if step == 0:
            task = asyncio.ensure_future(self._prefill_chunked(nonce, list(token_ids), decoding, step))
            self._prefill_tasks.add(task)
            task.add_done_callback(self._prefill_tasks.discard)
        elif nonce not in self.engine.sessions:
            # mid-generation session loss: fail fast instead of re-prefilling
            # from the last sampled token alone
            self._futures.resolve(
                TokenResult(nonce=nonce, token_id=-1, error=f"session expired for request {nonce}", step=step)
            )
        else:
            self._pending[nonce] = (token_ids[-1], decoding, step, budget)
            self._kick.set()

    def _cancelled(self, nonce: str, step: int) -> bool:
        return (nonce, step) not in self._futures._futures

    async def _prefill_chunked(self, nonce: str, ids: List[int], decoding: DecodingParams, step: int) -> None:
        loop = asyncio.get_running_loop()
        eng = self.engine
        try:
            # claim a batch slot BEFORE burning any prefill compute
            await loop.run_in_executor(self._executor, eng.reserve_slot, nonce)
            logits = None
            for i in range(0, len(ids), self.PREFILL_CHUNK):
                if self._cancelled(nonce, step):
                    await loop.run_in_executor(self._executor, eng.abandon_prefill, nonce)
                    return
                chunk = ids[i : i + self.PREFILL_CHUNK]
                logits = await loop.run_in_executor(
                    self._executor, eng.prefill_chunk, nonce, chunk, decoding.seed
                )
            if self._cancelled(nonce, step):
                await loop.run_in_executor(self._executor, eng.abandon_prefill, nonce)
                return
            res = await loop.run_in_executor(self._executor, eng.adopt_prefilled, nonce, logits, decoding)
            self._futures.resolve(eng.token_result(nonce, res, step=step, decoding=decoding))
        except Exception as exc:
            log.exception("chunked batched prefill failed")
            try:
                await loop.run_in_executor(self._executor, eng.abandon_prefill, nonce)
            except Exception as abandon_exc:  # executor already shut down
                log.debug("abandon_prefill skipped for %s: %s", nonce, abandon_exc)
            self._futures.resolve(TokenResult(nonce=nonce, token_id=-1, error=str(exc), step=step))

    async def _batch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await self._kick.wait()
            self._kick.clear()
            await asyncio.sleep(0)  # coalesce: let concurrent senders enqueue
            pending, self._pending = self._pending, {}
            if pending:
                await loop.run_in_executor(self._executor, self._batched_step, pending)

    async def await_token(self, nonce: str, step: int, timeout: float) -> TokenResult:
        return await self._futures.wait(nonce, step, timeout)

    def _batched_step(self, pending: Dict[str, tuple]) -> None:
        try:
            reqs = {n: (tok, dec) for n, (tok, dec, _step, _b) in pending.items()}
            # budgets widen the dispatch into R-step chunks: extras buffer
            # engine-side and resolve later steps without a dispatch
            budgets = {n: b for n, (_t, _d, _s, b) in pending.items()}
            results, errors = self.engine.decode_batch(reqs, budgets=budgets)
        except Exception as exc:
            log.exception("batched decode step failed")
            for nonce, (_tok, _dec, step, _b) in pending.items():
                self._futures.resolve(TokenResult(nonce=nonce, token_id=-1, error=str(exc), step=step))
            return
        for nonce, res in results.items():
            _tok, dec, step, _b = pending[nonce]
            self._futures.resolve(self.engine.token_result(nonce, res, step=step, decoding=dec))
        for nonce, msg in errors.items():
            _tok, _dec, step, _b = pending[nonce]
            self._futures.resolve(TokenResult(nonce=nonce, token_id=-1, error=msg, step=step))


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
        self._sweep_task = asyncio.ensure_future(_sweep_loop(self))

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
