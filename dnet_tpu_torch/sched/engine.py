"""SchedulerAdapter: the iteration-level tick loop behind DNET_SCHED=1.

Counterpart of dnet_tpu/sched/engine.py.  One adapter replaces the
kick-coalescing BatchedLocalAdapter and its per-request chunked prefill:
every tick the policy packs a token budget of chunked-prefill segments
plus one decode step per running sequence into a single
:class:`~dnet_tpu_torch.sched.policy.TickPlan`, the compute thread
executes it (``sched/step.py``), and the loop applies the results to the
per-request state machines (``sched/queue.py``).  The driver protocol
(``ApiAdapterBase``) is unchanged: InferenceManager and the HTTP layer
cannot tell this adapter from the legacy ones, which is what makes the
byte-identical parity with the reference's scheduler server possible.

Admission is a function of free paged-KV blocks and batch slots;
deadlines order both admission and preemption.  Preempted sequences
return to WAITING with their paged prefix aliased into the prefix cache
and resume transparently: the pending driver step rides along and
resolves from the resume's adopt sample.  Every tick is recorded in the
flight ring (sched/flight.py) that ``GET /v1/debug/sched`` serves (with
obs off too, unlike the reference, which records only under
``obs_enabled()``), and feeds the reference's dnet_sched_* metrics and its
``preempted`` events.  /v1/embeddings runs on the batched engine's inner
LocalEngine, on the compute thread.

Under the wire pipeline (DNET_WIRE_PIPELINE=1) a tick with prefills hands
each decode result to the loop as soon as the batched dispatch lands
(execute_tick's `on_decode`, `_dispatch_decode`), so decode steps resolve
while the tick's prefill chunks still run; the apply then skips them.
"""

from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from dnet_tpu_torch.api.strategies import ApiAdapterBase, _embed_on_executor, _reap, _TokenFutures
from dnet_tpu_torch.config import sched_settings
from dnet_tpu_torch.core.types import DecodingParams, TokenResult
from dnet_tpu_torch.obs import metric
from dnet_tpu_torch.obs.events import log_event
from dnet_tpu_torch.transport.wire_pipeline import wire_pipeline_enabled
from dnet_tpu_torch.sched.flight import get_tick_recorder
from dnet_tpu_torch.sched.kinds import QUEUE_STATES, STATE_DECODING
from dnet_tpu_torch.sched.policy import SchedulerPolicy, TickPlan
from dnet_tpu_torch.sched.queue import SchedQueue
from dnet_tpu_torch.sched.step import MAX_STARVED_REQUEUES, TickResult, execute_tick
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

_TICK_MS = metric("dnet_sched_tick_ms")
_BATCH_TOKENS = metric("dnet_sched_batch_tokens")
_PREEMPTIONS = metric("dnet_sched_preemptions_total")


class SchedulerAdapter(ApiAdapterBase):
    """Iteration-level continuous batching over a BatchedEngine (dense or
    paged + ragged slots): it needs the chunked-prefill serving surface
    (``reserve_slot`` / ``seed_from_prefix`` / ``prefill_chunk`` /
    ``adopt_prefilled`` / ``decode_batch`` + slot lifecycle)."""

    SWEEP_INTERVAL_S = 60.0

    def __init__(self, engine, token_budget: Optional[int] = None,
                 prefill_chunk: Optional[int] = None) -> None:
        sched = sched_settings()
        if not hasattr(engine, "prefill_chunk"):
            raise TypeError(
                f"SchedulerAdapter needs the chunked-prefill engine surface; "
                f"{type(engine).__name__} does not expose it"
            )
        self.engine = engine
        self.policy = SchedulerPolicy(
            token_budget=token_budget or sched.sched_token_budget,
            prefill_chunk=prefill_chunk or sched.sched_prefill_chunk,
        )
        self.queue = SchedQueue()
        self._futures = _TokenFutures()
        self._executor: Optional[ThreadPoolExecutor] = None
        self._kick: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._sweep_task: Optional[asyncio.Task] = None
        # deadline stamped by the driver before step 0 arrives (set_deadline
        # precedes the first send); loop-owned
        self._deadlines: Dict[str, float] = {}

    # ---- lifecycle ----------------------------------------------------
    async def start(self) -> None:
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="compute")
        self._kick = asyncio.Event()
        self._task = asyncio.ensure_future(self._tick_loop())
        self._sweep_task = asyncio.ensure_future(self._sweep_loop())

    async def shutdown(self) -> None:
        task, self._task = self._task, None
        await _reap(task, "scheduler tick loop")
        sweep, self._sweep_task = self._sweep_task, None
        await _reap(sweep, "session sweep")
        if self._executor:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None

    async def _sweep_loop(self) -> None:
        """Periodic TTL sweep: a client that vanished without reset_cache
        must not pin its slot, or its queue entry, forever."""
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.SWEEP_INTERVAL_S)
            if self._executor is None:
                return
            try:

                def _sweep_once():
                    # residency read on the compute thread, in the same task
                    # as the sweep: a tick between the two could preempt a
                    # request that would then be removed as swept
                    n_swept = self.engine.sweep_sessions()
                    return n_swept, set(self.engine.slot_of)

                n, resident = await loop.run_in_executor(self._executor, _sweep_once)
                # a swept DECODING session lost its engine residency: drop
                # the stale queue entry so its slot estimate frees too
                for req in list(self.queue.decoding()):
                    if req.nonce not in resident:
                        self.queue.remove(req.nonce)
                if n:
                    log.info("TTL sweep freed %d idle sessions", n)
                    self._wake()
            except Exception:
                log.exception("session sweep failed")

    # ---- driver surface -----------------------------------------------
    async def reset_cache(self, nonce: str) -> None:
        self.queue.remove(nonce)
        self._deadlines.pop(nonce, None)
        if self._executor is not None:
            await asyncio.get_running_loop().run_in_executor(
                self._executor, self.engine.end_session, nonce
            )
        self._futures.cancel_nonce(nonce)
        self._wake()  # a freed slot or freed blocks may unblock admission

    def set_deadline(self, nonce: str, deadline_ts: float) -> None:
        req = self.queue.get(nonce)
        if req is not None:
            req.deadline_ts = deadline_ts
        else:
            self._deadlines[nonce] = deadline_ts

    def max_seq(self) -> Optional[int]:
        return self.engine.max_seq

    async def embed(self, ids_list: List[List[int]]) -> List[List[float]]:
        return await _embed_on_executor(self.engine.eng.hidden_states, self._executor, ids_list)

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
            req = self.queue.add(
                nonce, list(token_ids), decoding, deadline_ts=self._deadlines.pop(nonce, None)
            )
            req.pending_step = 0
            req.pending_budget = budget
        else:
            req = self.queue.get(nonce)
            if req is None:
                # mid-generation loss (TTL sweep / reset race): fail fast
                # instead of silently re-prefilling from one token
                self._futures.resolve(
                    TokenResult(nonce=nonce, token_id=-1, step=step,
                                error=f"session expired for request {nonce}")
                )
                return
            # the driver echoes the accepted token as this step's input:
            # appending here keeps `ids` the exact replay source
            req.ids.append(token_ids[-1])
            req.pending_step = step
            req.pending_budget = budget
        self._wake()

    async def await_token(self, nonce: str, step: int, timeout: float) -> TokenResult:
        return await self._futures.wait(nonce, step, timeout)

    # ---- tick loop ----------------------------------------------------
    def _wake(self) -> None:
        if self._kick is not None:
            self._kick.set()

    async def _tick_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await self._kick.wait()
            self._kick.clear()
            await asyncio.sleep(0)  # coalesce: let concurrent senders enqueue
            plan = None
            # the whole tick body is guarded: an exception escaping this loop
            # would kill the task silently and wedge every current and future
            # request behind a kick nobody waits on
            try:
                plan = self.policy.plan(self.queue, self.engine)
                if plan.empty():
                    continue
                t0 = time.perf_counter()
                on_decode = None
                if plan.prefills and wire_pipeline_enabled():
                    # the loop's FIFO runs every early resolve before the
                    # executor future resumes _apply
                    on_decode = lambda nonce, sample: loop.call_soon_threadsafe(  # noqa: E731
                        self._dispatch_decode, plan, nonce, sample
                    )
                result = await loop.run_in_executor(self._executor, execute_tick, self.engine, plan, on_decode)
                tick_ms = (time.perf_counter() - t0) * 1000.0
                _TICK_MS.observe(tick_ms)
                _BATCH_TOKENS.labels(kind="prefill").observe(float(result.prefill_tokens))
                _BATCH_TOKENS.labels(kind="decode").observe(float(result.decode_lanes))
                self._apply(plan, result)
                self._record_tick(tick_ms, result)
                if self.policy.has_work(self.queue, self.engine):
                    self._wake()
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                log.exception("scheduler tick failed")
                if plan is not None:
                    self._fail_plan(plan, str(exc))
                else:
                    # planning itself failed, deterministically over the same
                    # queue: error the pending futures instead of wedging them
                    self._futures.fail_all(str(exc))
                continue

    def _record_tick(self, tick_ms: float, result: TickResult) -> None:
        """One TickRecord into the flight ring; queue depths are read after
        _apply, so the record shows the state the tick left behind."""
        pool = getattr(self.engine, "kv_pool", None)
        get_tick_recorder().record(
            tick_ms=tick_ms,
            budget_tokens=self.policy.token_budget,
            prefill_tokens=result.prefill_tokens,
            decode_lanes=result.decode_lanes,
            prefill_segments=result.prefill_segments,
            decode_steps=result.decode_steps,
            preempted=len(result.preempted),
            requeued=len(result.requeued),
            errors=len(result.errors),
            queue_depths={state: len(self.queue.by_state(state)) for state in QUEUE_STATES},
            kv_blocks_used=pool.used if pool is not None else 0,
            kv_blocks_free=pool.free if pool is not None else 0,
            kv_pool_blocks=pool.total if pool is not None else 0,
        )

    def _dispatch_decode(self, plan: TickPlan, nonce: str, sample) -> None:
        """An early decode resolution (the wire pipeline's tick dispatch), on
        the loop while the tick's prefill chunks run; _apply skips the
        nonces in TickResult.dispatched, so each resolves once."""
        step = plan.steps.get(nonce)
        if step is not None:
            self._resolve_step(nonce, step, sample=sample)

    def _fail_plan(self, plan: TickPlan, error: str) -> None:
        """A tick that died wholesale (executor torn down mid-flight): every
        participating pending step gets the error result."""
        for nonce, step in plan.steps.items():
            self._resolve_step(nonce, step, error=error)
        for chunk in plan.prefills:
            self._resolve_step(chunk.nonce, chunk.pending_step, error=error)

    def _resolve_step(self, nonce: str, step: int, sample=None, error: Optional[str] = None) -> None:
        req = self.queue.get(nonce)
        if error is not None:
            self._futures.resolve(TokenResult(nonce=nonce, token_id=-1, step=step, error=error))
            self.queue.remove(nonce)
            return
        decoding = req.decoding if req is not None else DecodingParams()
        self._futures.resolve(self.engine.token_result(nonce, sample, step=step, decoding=decoding))
        if req is not None and req.pending_step == step:
            req.pending_step = None
            req.pending_budget = None

    def _apply(self, plan: TickPlan, result: TickResult) -> None:
        for nonce in result.preempted:
            self.queue.requeue(nonce, reason_preempt=True)
            log_event("preempted", rid=nonce, reason="policy")
        for nonce in result.requeued:
            req = self.queue.get(nonce)
            if req is None:
                continue
            if req.starved + 1 >= MAX_STARVED_REQUEUES:
                self._resolve_step(
                    nonce,
                    req.pending_step if req.pending_step is not None else 0,
                    error=f"paged KV pool exhausted: prefill starved after {req.starved + 1} requeues",
                )
                continue
            self.queue.requeue(nonce, reason_preempt=False)
            _PREEMPTIONS.labels(reason="starved_requeue").inc()
            log_event("preempted", rid=nonce, reason="starved_requeue")
        for nonce, pos in result.progress.items():
            req = self.queue.get(nonce)
            if req is not None and req.state != STATE_DECODING:
                req.prefilled = pos
        for nonce, sample in result.adopted.items():
            req = self.queue.get(nonce)
            if req is None:
                continue
            req.state = STATE_DECODING
            req.prefilled = len(req.ids)
            req.starved = 0
            step = req.pending_step if req.pending_step is not None else 0
            self._resolve_step(nonce, step, sample=sample)
        dispatched = set(result.dispatched)
        for nonce, sample in result.decode_results.items():
            if nonce in dispatched:
                continue
            step = plan.steps.get(nonce)
            if step is None:
                continue
            self._resolve_step(nonce, step, sample=sample)
        for nonce, msg in result.errors.items():
            step = plan.steps.get(nonce)
            if step is None:
                req = self.queue.get(nonce)
                step = req.pending_step if req is not None and req.pending_step is not None else 0
            self._resolve_step(nonce, step, error=msg)
        self.queue.sync_gauges()
