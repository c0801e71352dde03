"""Request survival: retry/backoff policy, transparent decode resume, and
the seeded chaos harness that tests both.

Counterpart of dnet_tpu/resilience/:

- `policy`     — exponential backoff with full jitter for the ring's unary
  RPCs, the token callback and stream re-open (transient gRPC codes,
  connection and timeout errors);
- `checkpoint` — the resumable-request state machine the decode loop
  (api/inference.py) runs behind ``DNET_RESILIENCE_RESUME=1``;
- `chaos`      — seeded fault injection (``DNET_CHAOS``) at named points of
  the transport, the token callback, the failure monitor, shard compute,
  admission and the membership fences.

Import the submodules directly (``from dnet_tpu_torch.resilience import
chaos``).  This ``__init__`` imports nothing: the metrics registry's core
registration imports ``chaos`` for its point names, and an eager
``policy`` / ``checkpoint`` import here would re-enter the registry's lock
through their module-level `metric()` handles.
"""

__all__ = ["chaos", "checkpoint", "policy"]
