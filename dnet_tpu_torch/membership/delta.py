"""Delta reconfiguration: which shards actually need weights re-shipped.

On a re-solve, a shard whose load parameters are unchanged (same layer
range, window/residency, mesh axes, lanes/spec/prefix capacities, dtype,
...) does NOT need to re-read weights from disk — it only needs to bump
its epoch, drop per-request state (lanes/KV/snapshots), and rewire its
next pointer.  The signature is computed over the full per-shard
/load_model body minus the VOLATILE keys that legitimately change on
every reconfiguration, so any future load knob automatically participates
in the diff — a new body field can never be silently ignored by the delta
path.
"""

from __future__ import annotations

from typing import Dict, Tuple

# keys every reconfiguration rewrites; excluded from the change signature
VOLATILE_KEYS = ("next_node", "epoch")


def body_signature(body: dict) -> Tuple:
    """Order-independent, hashable signature of one shard's load body."""
    return tuple(
        sorted(
            (k, repr(v)) for k, v in body.items() if k not in VOLATILE_KEYS
        )
    )


def split_delta(
    last: Dict[str, Tuple], bodies: Dict[str, dict]
) -> Tuple[Dict[str, dict], Dict[str, dict]]:
    """Partition `bodies` (instance -> new load body) against `last`
    (instance -> signature of the body last successfully loaded) into
    (changed, unchanged).  An instance with no recorded signature is
    always `changed` — never skip a shard we have no proof about."""
    changed: Dict[str, dict] = {}
    unchanged: Dict[str, dict] = {}
    for instance, body in bodies.items():
        if last.get(instance) == body_signature(body):
            unchanged[instance] = body
        else:
            changed[instance] = body
    return changed, unchanged
