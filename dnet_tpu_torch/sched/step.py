"""Tick execution: one TickPlan against the batched engine.

Counterpart of dnet_tpu/sched/step.py.  ``execute_tick`` runs on the
compute thread (the adapter's single-worker executor, the same ownership
model as every other engine touch).  One tick is one mixed launch
sequence:

- the batched decode dispatch first (every running stream advances before
  any prompt token burns), with block-starvation preemption resolved
  before the dispatch so a pool shortfall evicts the lowest-priority
  sequence instead of failing an arbitrary lane; on paged slots the
  dispatch attends the block pool in place through the page tables (the
  paged kernel, ops/paged_attention.py), on dense slots each lane's row
  (the decode kernel, ops/flash_decode.py);
- then the tick's chunked-prefill segments on the engine's B=1 prefill
  (the prefill kernel, ops/flash_attention.py); a segment that completes
  its prompt is adopted into its batch lane and its first token sampled
  in the same tick.

Preemption keeps the paged prefix intact: the victim's committed KV is
aliased into the PagedPrefixCache (zero copy, refcounted) before its slot
is released, so its resume re-prefills only what the cache cannot cover.
A lane whose device position ran ahead of the driver-confirmed stream
(engine-buffered fused-chunk tokens) cannot be snapshotted consistently,
and store_prefix skips it.

The executor only reads the plan (loop-side snapshots) and the engine; it
never touches the scheduler queue.  Results flow back as plain data in a
:class:`TickResult` the loop applies.  Under the wire pipeline
(DNET_WIRE_PIPELINE=1) the adapter passes ``on_decode``, which hands each
decode result to the loop as soon as the batched dispatch lands, before
the tick's prefill chunks run.  Preemptions are counted in
dnet_sched_preemptions_total{reason}, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from dnet_tpu_torch.kv import KVPoolExhausted
from dnet_tpu_torch.obs import metric
from dnet_tpu_torch.sched.policy import PrefillChunk, TickPlan
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

_PREEMPTIONS = metric("dnet_sched_preemptions_total")

#: consecutive starved requeues before a prefill surfaces the typed
#: backpressure error instead of waiting for blocks that may never free
MAX_STARVED_REQUEUES = 8


@dataclass
class TickResult:
    #: nonce -> SampleResult from the batched decode dispatch
    decode_results: Dict[str, object] = field(default_factory=dict)
    #: nonce -> SampleResult sampled at prefill completion (adopt)
    adopted: Dict[str, object] = field(default_factory=dict)
    #: nonce -> absolute staged-token position after this tick's chunk
    progress: Dict[str, int] = field(default_factory=dict)
    errors: Dict[str, str] = field(default_factory=dict)
    #: DECODING sequences evicted back to WAITING (block starvation)
    preempted: List[str] = field(default_factory=list)
    #: PREFILLING requests that gave their staged work back (starved /
    #: lost the slot race) and should retry from WAITING
    requeued: List[str] = field(default_factory=list)
    #: nonces whose decode result was already handed off mid-tick through
    #: the wire-pipeline dispatch seam (execute_tick's on_decode) — the
    #: loop-side apply must not resolve these a second time
    dispatched: List[str] = field(default_factory=list)
    prefill_tokens: int = 0
    decode_lanes: int = 0
    #: prefill forward passes (chunks that ran) and batched decode forward
    #: steps (a fused R-step dispatch counts R) this tick: what the kernel
    #: launch counts are held against
    prefill_segments: int = 0
    decode_steps: int = 0


def _decode_need(engine, nonces) -> int:
    """Fresh blocks the pool must cover for one decode step across these
    lanes (R=1 floor; the engine's own extension shrinks wider fused
    chunks down to it under pressure)."""
    cfg = engine._kv_cfg
    need = 0
    for n in nonces:
        slot = engine.slot_of.get(n)
        if slot is None:
            continue
        tbl = engine._tables[slot]
        have = len(tbl.blocks) if tbl is not None else 0
        need += max(cfg.blocks_for(int(engine.pos[slot]) + 1) - have, 0)
    return need


def _preempt(engine, nonce: str, ids: List[int]) -> None:
    """Evict one DECODING sequence: alias its committed KV into the prefix
    cache (paged prefix intact — resume re-prefills only the uncovered
    tail), then release its slot, blocks, and inner session.  A lane whose
    device position ran ahead of the driver-confirmed stream (engine-
    buffered fused-chunk tokens) skips the alias — store_prefix refuses
    the inconsistent snapshot — and its resume recomputes the dropped
    lookahead (greedy-deterministic, so the stream is unchanged)."""
    slot = engine.slot_of.get(nonce)
    if slot is not None and ids:
        committed = ids[: int(engine.pos[slot])]
        try:
            engine.store_prefix(nonce, committed)
        except Exception as exc:
            # losing the alias only costs the resume a re-prefill
            log.debug("preemption prefix store for %s skipped: %s", nonce, exc)
    engine.end_session(nonce)
    _PREEMPTIONS.labels(reason="block_starvation").inc()


def _preempt_for_decode(engine, plan: TickPlan, reqs: dict, res: TickResult) -> None:
    """Evict lowest-priority lanes until the pool covers this tick's
    decode extensions.  The most urgent lane is never evicted."""
    victims = [v for v in plan.victims if v in engine.slot_of]
    while len(victims) > 1 and reqs:
        need = _decode_need(engine, reqs)
        if need <= engine.kv_pool.free:
            return
        v = victims.pop(0)
        _preempt(engine, v, plan.ids.get(v, []))
        res.preempted.append(v)
        reqs.pop(v, None)


def _run_prefill_chunk(
    engine, plan: TickPlan, chunk: PrefillChunk, res: TickResult
) -> None:
    nonce = chunk.nonce
    if chunk.first:
        try:
            engine.reserve_slot(nonce)
        except RuntimeError as exc:
            if "no free batch slots" in str(exc):
                # the loop-side slot estimate lost a race (TTL sweep /
                # concurrent teardown): a clean retry, never a client error
                res.requeued.append(nonce)
                return
            raise
        engine.seed_from_prefix(nonce, chunk.ids, chunk.seed)
    sess = engine.eng.sessions.get(nonce)
    cur = int(sess.pos) if sess is not None else 0
    end = max(min(chunk.end, len(chunk.ids)), cur)
    piece = chunk.ids[cur:] if chunk.last else chunk.ids[cur:end]
    logits = None
    if piece:
        try:
            logits = engine.prefill_chunk(nonce, piece, chunk.seed)
        except KVPoolExhausted as exc:
            _handle_prefill_starvation(engine, plan, chunk, res, cur, exc)
            return
        res.prefill_tokens += len(piece)
        res.prefill_segments += 1
    res.progress[nonce] = cur + len(piece)
    if not chunk.last:
        return
    while True:
        try:
            engine.store_prefix(nonce, chunk.ids)
            sample = engine.adopt_prefilled(nonce, logits, chunk.decoding)
        except KVPoolExhausted as exc:
            victims = [
                v
                for v in chunk.victims
                if v in engine.slot_of and v not in res.preempted
            ]
            if victims:
                # evict and retry IN THIS TICK: end_session frees the
                # victim's blocks synchronously, and a next-tick retry is
                # impossible here — the chunks are fully committed, so a
                # re-driven tick would have no logits left to adopt from
                _preempt(engine, victims[0], plan.ids.get(victims[0], []))
                res.preempted.append(victims[0])
                continue
            _handle_prefill_starvation(engine, plan, chunk, res, cur, exc)
            return
        except Exception as exc:
            log.exception("scheduler prefill adopt failed for %s", nonce)
            engine.abandon_prefill(nonce)
            res.errors[nonce] = str(exc)
            return
        break
    res.adopted[nonce] = sample


def _handle_prefill_starvation(
    engine,
    plan: TickPlan,
    chunk: PrefillChunk,
    res: TickResult,
    cur: int,
    exc: KVPoolExhausted,
) -> None:
    """A prefill segment the pool refused before committing anything.

    With a strictly-lower-priority DECODING victim available: evict it
    (its blocks free now) and keep this request's staged session — the
    next tick retries the same segment against the refilled pool (safe
    here because the chunk pre-check raises before any KV commits; the
    adopt-time starvation retries in-tick instead, see the caller).  With
    no victim but other residents: give the staged work back and retry
    from WAITING once their blocks free (bounded by the loop's starved
    counter).  Alone: surface the typed backpressure error — nothing will
    ever free the blocks this prompt needs."""
    victims = [
        v
        for v in chunk.victims
        if v in engine.slot_of and v not in res.preempted
    ]
    if victims:
        v = victims[0]
        _preempt(engine, v, plan.ids.get(v, []))
        res.preempted.append(v)
        res.progress[chunk.nonce] = cur  # staged work kept; retry next tick
        return
    others = [n for n in engine.slot_of if n != chunk.nonce]
    engine.abandon_prefill(chunk.nonce)
    if others:
        res.requeued.append(chunk.nonce)
        return
    res.errors[chunk.nonce] = str(exc)


def execute_tick(engine, plan: TickPlan, on_decode=None) -> TickResult:
    """One tick on the compute thread.  ``on_decode`` is the wire-pipeline
    dispatch seam (DNET_WIRE_PIPELINE=1): when set, each decode result is
    handed off the moment the batched dispatch lands — BEFORE this tick's
    prefill chunks run — so decode futures resolve (and, on a ring, the
    next hop's frames launch) while prompt tokens are still burning,
    instead of barriering the whole tick behind its slowest segment.
    Results dispatched this way are also recorded in ``dispatched`` so the
    loop-side apply doesn't resolve them twice."""
    res = TickResult()
    reqs = dict(plan.decode)
    if reqs and getattr(engine, "kv_pool", None) is not None:
        _preempt_for_decode(engine, plan, reqs, res)
    if reqs:
        budgets = {n: plan.budgets.get(n) for n in reqs}
        steps0 = getattr(engine, "decode_steps", 0)
        out, errs = engine.decode_batch(reqs, budgets=budgets)
        res.decode_steps = getattr(engine, "decode_steps", 0) - steps0
        res.decode_results.update(out)
        res.errors.update(errs)
        res.decode_lanes = len(reqs)
        if on_decode is not None:
            for nonce, sample in out.items():
                try:
                    on_decode(nonce, sample)
                    res.dispatched.append(nonce)
                except Exception:
                    # a failed early dispatch falls back to the barriered
                    # apply path — the result is still in decode_results
                    log.exception("early decode dispatch failed for %s", nonce)
    for chunk in plan.prefills:
        if chunk.nonce in res.preempted:
            continue
        try:
            _run_prefill_chunk(engine, plan, chunk, res)
        except Exception as exc:
            log.exception("scheduler prefill chunk failed for %s", chunk.nonce)
            try:
                engine.abandon_prefill(chunk.nonce)
            except Exception as inner:
                log.debug("abandon_prefill after failure: %s", inner)
            res.errors[chunk.nonce] = str(exc)
    return res
