"""Topology epochs: the ring's fencing token.

Counterpart of dnet_tpu/membership/epoch.py.

Every solved topology the API installs gets a monotonically increasing
epoch (`EpochClock.mint`, owned by ClusterManager).  The epoch rides every
place state crosses a process boundary — the /load_model fan-out pins it
on each shard, activation frames and token callbacks carry it, reset_cache
names it — and any receiver holding a different (nonzero) epoch rejects
the message with a typed `StaleEpochError` that is COUNTED
(`dnet_stale_epoch_rejected_total{kind=}`), never computed.  Epoch 0 means
"unfenced" (pre-epoch senders, single-process adapters): a fence only
trips when BOTH sides carry a nonzero epoch and they differ, so legacy
frames and tests keep working.

`STALE_EPOCH_KINDS` / `RECOVERY_OUTCOMES` are leaf enums imported by
`dnet_tpu_torch.obs` to pre-touch one labeled series per value — keep this
module import-light so obs can pull the enums without a cycle.
"""

from __future__ import annotations

from typing import Tuple

# Where a stale-epoch message was fenced out.  `frame` is the shard
# ingress fence (activation/relay frames), `token_cb` the API-side fence
# on shard->API token callbacks (the zombie-token hole), `reset_cache`
# the shard's control-plane fence.
STALE_EPOCH_KINDS: Tuple[str, ...] = (
    "frame",        # shard ingress rejected an activation/relay frame
    "token_cb",     # API rejected a token callback minted under an old epoch
    "reset_cache",  # shard rejected a reset RPC from a different epoch
    "fleet_route",  # fleet router fenced a dispatch to a zombie replica
)

# How a recovery round (failure re-solve or rejoin re-solve) ended.
RECOVERY_OUTCOMES: Tuple[str, ...] = (
    "recovered",    # new topology solved, reloaded, and serving
    "failed",       # reload failed after retries; previous topology restored
    "no_capacity",  # no healthy shards left / model no longer fits
)


class StaleEpochError(Exception):
    """A message minted under a topology epoch the receiver no longer
    holds.  The authoritative fence that makes re-solve safe under
    partition: a "dead" shard that was merely partitioned cannot inject
    frames/tokens/resets from the old ring into the new one."""

    def __init__(self, kind: str, held: int, got: int) -> None:
        self.kind = kind
        self.held = int(held)
        self.got = int(got)
        super().__init__(
            f"stale epoch: {kind} carries epoch {got}, holder is at "
            f"epoch {held}"
        )


def is_stale(held: int, got: int) -> bool:
    """True when a fence should trip: both sides epoch-aware, epochs
    differ.  0 on either side = unfenced (legacy sender / no topology)."""
    return bool(held) and bool(got) and int(held) != int(got)


def reject(kind: str, held: int, got: int) -> StaleEpochError:
    """Count one stale-epoch rejection and build the typed error.

    Returns (rather than raises) so ACK-shaped call sites — the shard
    ingress fence answers with a NACK message, the API token fence just
    drops — can use the same counted path as raising call sites."""
    from dnet_tpu_torch.obs import metric  # lazy: keep this module a leaf
    from dnet_tpu_torch.obs.events import log_event

    metric("dnet_stale_epoch_rejected_total").labels(kind=kind).inc()
    log_event("epoch_fenced", kind=kind, held=int(held), got=int(got))
    return StaleEpochError(kind, held, got)


def set_epoch_gauge(epoch: int) -> None:
    """Publish the epoch this process currently holds (API: minted; shard:
    pinned at load).  The federation scrape then shows a mixed-epoch ring
    at a glance."""
    from dnet_tpu_torch.obs import metric

    metric("dnet_topology_epoch").set(float(epoch))


class EpochClock:
    """Monotonic epoch mint, owned by the API's ClusterManager.  One clock
    per process lifetime: every install_topology() gets a strictly larger
    epoch, so a rolled-back recovery can never reuse a fenced value."""

    def __init__(self, start: int = 0) -> None:
        self._epoch = int(start)

    @property
    def current(self) -> int:
        return self._epoch

    def mint(self) -> int:
        self._epoch += 1
        set_epoch_gauge(self._epoch)
        return self._epoch

    def observe(self, epoch: int) -> None:
        """Fast-forward past an externally seen epoch (defensive: keeps
        mint() strictly increasing even if a topology arrived with a
        larger epoch than this clock ever issued)."""
        if int(epoch) > self._epoch:
            self._epoch = int(epoch)
