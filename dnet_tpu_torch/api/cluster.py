"""ClusterManager: the shard table and the current topology.

Counterpart of dnet_tpu/api/cluster.py for hostfile rings: discovery's
peers, parallel health checks, the installed topology and its epoch.  The
epoch is minted at install and shipped to every shard, which stamps it on
its egress; this slice fences nothing with it.
"""

from __future__ import annotations

import asyncio
from typing import List, Optional

import aiohttp

from dnet_tpu_torch.core.types import DeviceInfo, TopologyInfo
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


class ClusterManager:
    def __init__(self, discovery) -> None:
        self.discovery = discovery
        self.current_topology: Optional[TopologyInfo] = None
        self._last_epoch = 0

    @property
    def epoch(self) -> int:
        """Epoch of the installed topology (0 = none)."""
        topo = self.current_topology
        return topo.epoch if topo is not None else 0

    def install_topology(self, topo: TopologyInfo) -> TopologyInfo:
        """Mint a fresh, strictly larger epoch for `topo` and make it current."""
        self._last_epoch = max(self._last_epoch, topo.epoch) + 1
        topo.epoch = self._last_epoch
        self.current_topology = topo
        log.info("topology installed: epoch %d over %d shard(s)", topo.epoch, len(topo.assignments))
        return topo

    async def scan_devices(self) -> List[DeviceInfo]:
        # manager (API) nodes are not compute shards
        return [d for d in self.discovery.peers() if not d.is_manager]

    async def healthy_devices(self, timeout_s: float = 5.0) -> List[DeviceInfo]:
        """Parallel /health checks; unreachable shards are left out."""
        devices = await self.scan_devices()
        timeout = aiohttp.ClientTimeout(total=timeout_s)
        async with aiohttp.ClientSession(timeout=timeout) as session:

            async def check(d: DeviceInfo) -> Optional[DeviceInfo]:
                url = f"http://{d.host}:{d.http_port}/health"
                try:
                    async with session.get(url) as r:
                        if r.status == 200:
                            return d
                except (aiohttp.ClientError, asyncio.TimeoutError):
                    pass
                log.warning("shard %s unhealthy (%s)", d.instance, url)
                return None

            results = await asyncio.gather(*(check(d) for d in devices))
        return [d for d in results if d is not None]

    def head_device(self) -> Optional[DeviceInfo]:
        """Owner of layer 0 in the current topology."""
        if self.current_topology is None:
            return None
        head = self.current_topology.head_instance()
        return next((d for d in self.current_topology.devices if d.instance == head), None)
