"""Scheduler tick flight recorder: a bounded ring of per-tick records.

Counterpart of dnet_tpu/sched/flight.py.  One :class:`TickRecord` per
executed tick (from ``sched/engine.py``'s tick loop) lands in a bounded
ring, surfaced raw by ``GET /v1/debug/sched`` (api/http.py): which ticks
wasted budget, how many decode lanes and prompt tokens each packed, what
the queue looked like when a preemption fired, whether the block pool was
pinned when a prefill starved.  Bounded by DNET_OBS_TICK_RECORDS (256;
0 disables capture), so retention is O(1) regardless of traffic.  The reference's aggregate
metrics (dnet_sched_tick_records_total, the budget-used histogram) are
not kept: the snapshot's summary carries the same sums.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from dnet_tpu_torch.config import obs_settings
from dnet_tpu_torch.sched.kinds import QUEUE_STATES


@dataclass
class TickRecord:
    """One executed scheduler tick, as the policy planned and the compute
    thread delivered it."""

    seq: int                 # monotone capture index (not reset by eviction)
    t_unix: float            # wall clock at capture (tick end)
    tick_ms: float           # execute_tick wall time on the compute thread
    budget_tokens: int       # the policy's per-tick token budget
    budget_used: int         # prefill tokens + decode lanes packed
    budget_wasted: int       # budget - used (0 on a saturated tick)
    prefill_tokens: int      # prompt tokens chunk-prefilled this tick
    decode_lanes: int        # decode lanes stepped this tick
    prefill_segments: int    # prefill forward passes (chunks) this tick
    decode_steps: int        # batched decode forward steps this tick
    preempted: int           # sequences evicted back to WAITING
    requeued: int            # starved prefills requeued
    errors: int              # per-nonce errors the tick surfaced
    queue_depths: Dict[str, int] = field(default_factory=dict)
    kv_blocks_used: int = 0
    kv_blocks_free: int = 0
    kv_pool_blocks: int = 0

    def as_dict(self) -> dict:
        return asdict(self)


class TickFlightRecorder:
    """Bounded ring of TickRecords (thread-safe: the tick loop records
    from the event loop, /v1/debug/sched snapshots from a handler)."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        # None: DNET_OBS_TICK_RECORDS, read at each record
        self._capacity = capacity
        self._lock = threading.Lock()
        self._records: "deque[TickRecord]" = deque()
        self._seq = 0

    def capacity(self) -> int:
        n = obs_settings().tick_records if self._capacity is None else self._capacity
        return max(int(n), 0)

    def record(
        self,
        *,
        tick_ms: float,
        budget_tokens: int,
        prefill_tokens: int,
        decode_lanes: int,
        prefill_segments: int = 0,
        decode_steps: int = 0,
        preempted: int = 0,
        requeued: int = 0,
        errors: int = 0,
        queue_depths: Optional[Dict[str, int]] = None,
        kv_blocks_used: int = 0,
        kv_blocks_free: int = 0,
        kv_pool_blocks: int = 0,
    ) -> Optional[TickRecord]:
        """Capture one tick; returns the record (None when capture is
        disabled: capacity 0)."""
        cap = self.capacity()
        if cap <= 0:
            return None
        used = int(prefill_tokens) + int(decode_lanes)
        rec = TickRecord(
            seq=0,
            t_unix=time.time(),
            tick_ms=round(float(tick_ms), 3),
            budget_tokens=int(budget_tokens),
            budget_used=used,
            budget_wasted=max(int(budget_tokens) - used, 0),
            prefill_tokens=int(prefill_tokens),
            decode_lanes=int(decode_lanes),
            prefill_segments=int(prefill_segments),
            decode_steps=int(decode_steps),
            preempted=int(preempted),
            requeued=int(requeued),
            errors=int(errors),
            queue_depths=dict(queue_depths or {}),
            kv_blocks_used=int(kv_blocks_used),
            kv_blocks_free=int(kv_blocks_free),
            kv_pool_blocks=int(kv_pool_blocks),
        )
        with self._lock:
            rec.seq = self._seq
            self._seq += 1
            self._records.append(rec)
            while len(self._records) > cap:
                self._records.popleft()
        return rec

    def records(self) -> List[TickRecord]:
        with self._lock:
            return list(self._records)

    def snapshot(self) -> dict:
        """JSON-ready ring dump + aggregate summary — the
        GET /v1/debug/sched payload."""
        records = self.records()
        n = len(records)
        summary = {
            "ticks_captured": self._seq,
            "ticks_retained": n,
            "capacity": self.capacity(),
        }
        if n:
            ticks_ms = [r.tick_ms for r in records]
            summary.update({
                "tick_ms_mean": round(sum(ticks_ms) / n, 3),
                "tick_ms_max": round(max(ticks_ms), 3),
                "prefill_tokens": sum(r.prefill_tokens for r in records),
                "decode_lanes": sum(r.decode_lanes for r in records),
                "prefill_segments": sum(r.prefill_segments for r in records),
                "decode_steps": sum(r.decode_steps for r in records),
                "budget_wasted": sum(r.budget_wasted for r in records),
                "budget_used_ratio": round(
                    sum(r.budget_used for r in records)
                    / max(sum(r.budget_tokens for r in records), 1),
                    4,
                ),
                "preempted": sum(r.preempted for r in records),
                "requeued": sum(r.requeued for r in records),
                "errors": sum(r.errors for r in records),
                "queue_depths_last": records[-1].queue_depths,
            })
        return {
            "summary": summary,
            "states": list(QUEUE_STATES),
            "records": [r.as_dict() for r in records],
        }

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._seq = 0


_tick_recorder = TickFlightRecorder()


def get_tick_recorder() -> TickFlightRecorder:
    """The process-global tick ring."""
    return _tick_recorder
