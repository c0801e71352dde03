"""Elastic ring membership: topology epochs, zombie fencing, rejoin.

Counterpart of dnet_tpu/membership/.  A one-shot solve would leave a ring
that lost a shard with nothing but a full-cluster reload, and the lost
shard pruned from monitoring for good.  This package treats ring
membership as dynamic state:

- every installed topology carries a monotonically increasing **epoch**
  (`epoch.EpochClock`, minted by the API's ClusterManager) that rides every
  cross-process hop — load fan-out, activation frames, token callbacks,
  reset_cache — and shards pin it at load;
- `epoch.StaleEpochError` + `epoch.reject()` are the authoritative fence:
  state minted under a dead epoch is rejected and counted
  (`dnet_stale_epoch_rejected_total{kind=}`), never computed — the thing
  that makes re-solve safe under partition (zombie/split-brain);
- `quarantine.QuarantineSet` keeps fenced-out shards health-probed instead
  of pruned, so a shard that comes back green for `DNET_REJOIN_STABLE_S`
  can rejoin (behind `DNET_REJOIN=1`) without operator action;
- `delta.body_signature` backs delta reconfiguration: on re-solve, only
  shards whose load parameters changed re-ship weights — unchanged shards
  bump epoch and drop per-request state via `/update_topology`.
"""

from dnet_tpu_torch.membership.delta import body_signature, split_delta
from dnet_tpu_torch.membership.epoch import (
    RECOVERY_OUTCOMES,
    STALE_EPOCH_KINDS,
    EpochClock,
    StaleEpochError,
    is_stale,
    reject,
    set_epoch_gauge,
)
from dnet_tpu_torch.membership.quarantine import QuarantinedShard, QuarantineSet

__all__ = [
    "RECOVERY_OUTCOMES",
    "STALE_EPOCH_KINDS",
    "EpochClock",
    "QuarantineSet",
    "QuarantinedShard",
    "StaleEpochError",
    "body_signature",
    "is_stale",
    "reject",
    "set_epoch_gauge",
    "split_delta",
]
