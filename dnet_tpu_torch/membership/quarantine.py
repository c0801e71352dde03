"""Quarantine: fenced-out shards that stay health-probed.

Before this, a permanently lost shard was pruned from monitoring the
moment recovery re-solved without it — no path back to full capacity
short of an operator re-prepare.  The quarantine list is the path back:
the failure monitor moves a shard here when a re-solve excludes it, keeps
probing its gRPC health every tick, and (behind `DNET_REJOIN=1`) a shard
that stays green for `DNET_REJOIN_STABLE_S` seconds becomes a rejoin
candidate — re-profiled, re-solved, and delta-reloaded back into the ring
without operator action.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dnet_tpu_torch.core.types import DeviceInfo


@dataclass
class QuarantinedShard:
    """One fenced-out shard and its probe history."""

    device: DeviceInfo
    since: float = field(default_factory=time.monotonic)
    green_since: Optional[float] = None  # first consecutive healthy probe
    probes_ok: int = 0
    last_error: str = ""

    @property
    def instance(self) -> str:
        return self.device.instance

    @property
    def addr(self) -> str:
        return f"{self.device.host}:{self.device.grpc_port}"

    def mark_green(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self.green_since is None:
            self.green_since = now
        self.probes_ok += 1
        self.last_error = ""

    def mark_red(self, error: str = "") -> None:
        self.green_since = None
        self.probes_ok = 0
        self.last_error = error

    def stable_for(self, now: Optional[float] = None) -> float:
        """Seconds of uninterrupted green probes (0 while red)."""
        if self.green_since is None:
            return 0.0
        now = time.monotonic() if now is None else now
        return max(now - self.green_since, 0.0)

    def defer(self, now: Optional[float] = None) -> None:
        """Restart the stability window (a failed/aborted rejoin attempt
        must not hot-loop: the shard re-earns its stable period)."""
        self.green_since = time.monotonic() if now is None else now


class QuarantineSet:
    """The fenced-out membership list, keyed by instance."""

    def __init__(self) -> None:
        self._shards: Dict[str, QuarantinedShard] = {}

    def __contains__(self, instance: str) -> bool:
        return instance in self._shards

    def __len__(self) -> int:
        return len(self._shards)

    def __bool__(self) -> bool:
        return bool(self._shards)

    def add(self, device: DeviceInfo) -> QuarantinedShard:
        """Quarantine a shard (idempotent: a re-quarantined shard keeps its
        original `since` but restarts its probe history — it just failed
        again)."""
        q = self._shards.get(device.instance)
        if q is None:
            q = self._shards[device.instance] = QuarantinedShard(device)
        else:
            q.device = device
            q.mark_red("re-quarantined")
        return q

    def remove(self, instance: str) -> Optional[QuarantinedShard]:
        return self._shards.pop(instance, None)

    def get(self, instance: str) -> Optional[QuarantinedShard]:
        return self._shards.get(instance)

    def instances(self) -> List[str]:
        return list(self._shards)

    def shards(self) -> List[QuarantinedShard]:
        return list(self._shards.values())

    def clear(self) -> None:
        self._shards.clear()

    def ready(
        self, stable_s: float, now: Optional[float] = None
    ) -> List[QuarantinedShard]:
        """Shards green for at least `stable_s` — rejoin candidates."""
        now = time.monotonic() if now is None else now
        return [
            q for q in self._shards.values()
            if q.green_since is not None and q.stable_for(now) >= stable_s
        ]

    def snapshot(self) -> dict:
        """Operator view for /health and the federation scrape."""
        now = time.monotonic()
        return {
            q.instance: {
                "quarantined_s": round(now - q.since, 1),
                "green_s": round(q.stable_for(now), 1),
                "probes_ok": q.probes_ok,
                "last_error": q.last_error,
            }
            for q in self._shards.values()
        }
