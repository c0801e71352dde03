"""Scheduler declaration data: request states, batch kinds and preemption
reasons.

Counterpart of dnet_tpu/sched/kinds.py.  A leaf module (stdlib only).
"""

from __future__ import annotations

#: Per-request scheduler states (queue.py state machine).  ``finished`` is
#: terminal and never holds queue residency.
STATE_WAITING = "waiting"
STATE_PREFILLING = "prefilling"
STATE_DECODING = "decoding"
STATE_FINISHED = "finished"

#: The live states a queue's depths are counted by.
QUEUE_STATES = (STATE_WAITING, STATE_PREFILLING, STATE_DECODING)

#: A tick's batch composition: prompt tokens that rode chunked-prefill
#: segments, and sequences that took a decode step.
BATCH_KINDS = ("prefill", "decode")

#: Why a request left the engine before finishing.
#: ``block_starvation``: the paged-KV pool could not cover a decode
#: extension or a prefill chunk, so the lowest-priority running sequence
#: was evicted back to WAITING (its committed prefix aliased into the
#: prefix cache where possible, so resume re-prefills only the rest).
#: ``starved_requeue``: a PREFILLING request gave its staged work back and
#: returned to WAITING because the pool could not cover its next chunk and
#: no lower-priority victim existed.
PREEMPT_REASONS = ("block_starvation", "starved_requeue")
