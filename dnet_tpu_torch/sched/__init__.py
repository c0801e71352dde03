"""Iteration-level continuous-batching scheduler (DNET_SCHED=1).

Counterpart of dnet_tpu/sched/: one serving adapter for mixed prefill +
decode.  Each tick packs a token budget of chunked-prefill segments and
one decode step per running sequence into a single plan (policy.py), runs
it on the batched engine (step.py), admits work as a function of free
paged-KV blocks, and preempts by block starvation with the paged prefix
kept in the prefix cache (kv/prefix.py).  Every tick is recorded in a
bounded ring (flight.py) served at GET /v1/debug/sched.
"""

from dnet_tpu_torch.sched.engine import SchedulerAdapter
from dnet_tpu_torch.sched.kinds import BATCH_KINDS, PREEMPT_REASONS, QUEUE_STATES
from dnet_tpu_torch.sched.policy import PrefillChunk, SchedulerPolicy, TickPlan
from dnet_tpu_torch.sched.queue import SchedQueue, SchedRequest
from dnet_tpu_torch.sched.step import TickResult, execute_tick

__all__ = [
    "BATCH_KINDS",
    "PREEMPT_REASONS",
    "QUEUE_STATES",
    "PrefillChunk",
    "SchedQueue",
    "SchedRequest",
    "SchedulerAdapter",
    "SchedulerPolicy",
    "TickPlan",
    "TickResult",
    "execute_tick",
]
