"""Per-request scheduler state machine and priority queue.

Counterpart of dnet_tpu/sched/queue.py.  Each request admitted by the API
driver becomes one :class:`SchedRequest` walking WAITING -> PREFILLING ->
DECODING -> FINISHED.  Ordering is deadline-first, then arrival (FIFO):
the deadline is the request's absolute one (``deadline_s`` or
DNET_REQUEST_DEADLINE_S, ridden through ``ApiAdapterBase.set_deadline``).
Preemption returns a DECODING request to WAITING with its ``arrival``
unchanged: priority is a stable total order and resources only flow up
it, so preemption cannot cycle.

The queue is owned by the event loop: policy and bookkeeping run there;
the compute thread only sees plain snapshots inside a
:class:`~dnet_tpu_torch.sched.policy.TickPlan`.  `depths` holds the counts
that the reference's dnet_sched_queue_depth{state} gauges export, and
`sync_gauges` sets both.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.obs import metric
from dnet_tpu_torch.sched.kinds import (
    QUEUE_STATES,
    STATE_DECODING,
    STATE_FINISHED,
    STATE_PREFILLING,
    STATE_WAITING,
)


_QUEUE_DEPTH = metric("dnet_sched_queue_depth")


@dataclass
class SchedRequest:
    """One request's scheduler-side state.

    ``ids`` is the replay source: the prompt plus every generated token the
    driver has sent back (the driver echoes each accepted token as the next
    step's input, so appending at ``send_tokens`` time keeps ``ids`` one
    step ahead of the engine's committed KV).  A preempted request
    re-prefills ``ids``; the prefix blocks aliased at eviction make that
    mostly a block-table walk, not compute.
    """

    nonce: str
    ids: List[int]
    decoding: DecodingParams
    arrival: int
    prompt_len: int
    deadline_ts: Optional[float] = None
    state: str = STATE_WAITING
    #: staging position: tokens of ``ids`` committed by chunked prefill so
    #: far (absolute, prefix-cache skips included)
    prefilled: int = 0
    #: the driver's outstanding step awaiting a token, or None
    pending_step: Optional[int] = None
    #: remaining token allowance the driver advertised with the pending
    #: step (widens decode dispatches into fused chunks)
    pending_budget: Optional[int] = None
    preemptions: int = 0
    #: consecutive starved requeues (bounded before the typed error)
    starved: int = 0
    extra: dict = field(default_factory=dict)

    def priority(self) -> Tuple[float, int]:
        """Sort key, smaller = more urgent: (deadline, arrival)."""
        return (self.deadline_ts if self.deadline_ts is not None else math.inf, self.arrival)


class SchedQueue:
    """nonce -> SchedRequest map with priority views and depth counts."""

    def __init__(self) -> None:
        self._arrival = 0
        self._reqs: Dict[str, SchedRequest] = {}
        self.depths: Dict[str, int] = {s: 0 for s in QUEUE_STATES}

    def __len__(self) -> int:
        return len(self._reqs)

    def __contains__(self, nonce: str) -> bool:
        return nonce in self._reqs

    def get(self, nonce: str) -> Optional[SchedRequest]:
        return self._reqs.get(nonce)

    def add(
        self,
        nonce: str,
        prompt_ids: List[int],
        decoding: DecodingParams,
        deadline_ts: Optional[float] = None,
    ) -> SchedRequest:
        self._arrival += 1
        req = SchedRequest(
            nonce=nonce,
            ids=list(prompt_ids),
            decoding=decoding,
            arrival=self._arrival,
            prompt_len=len(prompt_ids),
            deadline_ts=deadline_ts,
        )
        self._reqs[nonce] = req
        self.sync_gauges()
        return req

    def remove(self, nonce: str) -> Optional[SchedRequest]:
        req = self._reqs.pop(nonce, None)
        if req is not None:
            req.state = STATE_FINISHED
            self.sync_gauges()
        return req

    def by_state(self, state: str) -> List[SchedRequest]:
        return [r for r in self._reqs.values() if r.state == state]

    def waiting(self) -> List[SchedRequest]:
        """WAITING requests, most urgent first."""
        return sorted(self.by_state(STATE_WAITING), key=SchedRequest.priority)

    def prefilling(self) -> List[SchedRequest]:
        """PREFILLING requests, most urgent first."""
        return sorted(self.by_state(STATE_PREFILLING), key=SchedRequest.priority)

    def decoding(self) -> List[SchedRequest]:
        return self.by_state(STATE_DECODING)

    def victims(self) -> List[str]:
        """DECODING nonces, least urgent first: the eviction order when the
        block pool starves."""
        return [
            r.nonce
            for r in sorted(self.by_state(STATE_DECODING), key=SchedRequest.priority, reverse=True)
        ]

    def requeue(self, nonce: str, reason_preempt: bool) -> None:
        """Return a running request to WAITING (preemption / starvation);
        its staged prefill is gone but ``arrival``, and so priority, is
        unchanged."""
        req = self._reqs.get(nonce)
        if req is None:
            return
        req.state = STATE_WAITING
        req.prefilled = 0
        if reason_preempt:
            req.preemptions += 1
        else:
            req.starved += 1
        self.sync_gauges()

    def active(self) -> int:
        """Requests currently holding engine-side residency."""
        return len(self.by_state(STATE_PREFILLING)) + len(self.by_state(STATE_DECODING))

    def sync_gauges(self) -> None:
        """Recount `depths`, the requests resident in each live state."""
        counts = {s: 0 for s in QUEUE_STATES}
        for r in self._reqs.values():
            if r.state in counts:
                counts[r.state] += 1
        self.depths = counts
        for state, n in counts.items():
            _QUEUE_DEPTH.labels(state=state).set(float(n))
