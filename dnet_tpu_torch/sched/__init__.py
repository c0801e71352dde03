"""Iteration-level continuous-batching scheduler (DNET_SCHED=1).

Counterpart of dnet_tpu/sched/: one serving adapter for mixed prefill +
decode.  Each tick packs a token budget of chunked-prefill segments and
one decode step per running sequence into a single plan (policy.py), runs
it on the batched engine (step.py), admits work as a function of free
paged-KV blocks, and preempts by block starvation with the paged prefix
kept in the prefix cache (kv/prefix.py).  Every tick is recorded in a
bounded ring (flight.py) served at GET /v1/debug/sched.

The exports resolve lazily (PEP 562), as the reference's: the metrics
registry's core registration imports ``sched.kinds`` for its label sets,
and an eager ``engine`` / ``queue`` import here would re-enter the
registry's lock through their module-level ``metric()`` handles.
"""

from __future__ import annotations

_EXPORTS = {
    "BATCH_KINDS": "dnet_tpu_torch.sched.kinds",
    "PREEMPT_REASONS": "dnet_tpu_torch.sched.kinds",
    "QUEUE_STATES": "dnet_tpu_torch.sched.kinds",
    "PrefillChunk": "dnet_tpu_torch.sched.policy",
    "SchedulerPolicy": "dnet_tpu_torch.sched.policy",
    "TickPlan": "dnet_tpu_torch.sched.policy",
    "SchedQueue": "dnet_tpu_torch.sched.queue",
    "SchedRequest": "dnet_tpu_torch.sched.queue",
    "SchedulerAdapter": "dnet_tpu_torch.sched.engine",
    "TickResult": "dnet_tpu_torch.sched.step",
    "execute_tick": "dnet_tpu_torch.sched.step",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)
