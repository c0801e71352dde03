"""ClusterManager: the shard table, profiling, and the current topology.

Counterpart of dnet_tpu/api/cluster.py: discovery's peers (a hostfile's
table, or UDP discovery's live one: utils/p2p.py), parallel health
checks, `profile_cluster` (each healthy shard's POST /profile, then each
one's POST /measure_latency to its ring neighbour: the solver's inputs),
and the installed topology.  Every
installed topology gets a strictly larger epoch from the `EpochClock`
(membership/epoch.py), shipped to every shard in its load body: the fence
against the shards a re-solve leaves out.
"""

from __future__ import annotations

import asyncio
from typing import List, Optional

import aiohttp

from dnet_tpu_torch.core.types import DeviceInfo, TopologyInfo
from dnet_tpu_torch.membership import EpochClock, set_epoch_gauge
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

# profile_cluster's probes: the whole fan-out's time limit, and the
# payload sizes (bytes) and rounds of each ring neighbour's latency probe
PROFILE_TIMEOUT_S = 300.0
LATENCY_PAYLOAD_SIZES = [65536, 1048576]
LATENCY_ROUNDS = 3


class ClusterManager:
    def __init__(self, discovery) -> None:
        self.discovery = discovery
        self.current_topology: Optional[TopologyInfo] = None
        self.epoch_clock = EpochClock()
        self.profile_errors: dict = {}  # instance -> the last profile's failure

    @property
    def epoch(self) -> int:
        """Epoch of the installed topology (0 = none)."""
        topo = self.current_topology
        return topo.epoch if topo is not None else 0

    def install_topology(self, topo: TopologyInfo) -> TopologyInfo:
        """Mint a fresh, strictly larger epoch for `topo` and make it current."""
        self.epoch_clock.observe(topo.epoch)
        topo.epoch = self.epoch_clock.mint()
        self.current_topology = topo
        log.info("topology installed: epoch %d over %d shard(s)", topo.epoch, len(topo.assignments))
        return topo

    def restore_topology(self, topo: Optional[TopologyInfo]) -> None:
        """Roll back to a previously installed topology (a failed reload):
        its epoch is current again, and the aborted one is never reused."""
        self.current_topology = topo
        set_epoch_gauge(topo.epoch if topo is not None else 0)

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

    async def profile_cluster(self) -> List[DeviceInfo]:
        """Health-filter -> parallel /profile -> /measure_latency between
        ring neighbours -> the merged DeviceInfo list.  A shard whose
        profile fails keeps its unprofiled fields, and the failure is kept
        in `profile_errors` (instance -> error) for the caller to refuse:
        /v1/prepare_topology answers 502 rather than solve over it."""
        self.profile_errors = {}
        devices = await self.healthy_devices()
        if not devices:
            return []
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=PROFILE_TIMEOUT_S)) as session:

            async def post(d: DeviceInfo, route: str, body: dict) -> dict:
                async with session.post(f"http://{d.host}:{d.http_port}{route}", json=body) as r:
                    r.raise_for_status()
                    return await r.json()

            async def profile_one(d: DeviceInfo) -> None:
                try:
                    p = (await post(d, "/profile", {}))["profile"]
                except (aiohttp.ClientError, asyncio.TimeoutError, KeyError) as exc:
                    log.warning("profile of %s failed: %s", d.instance, exc)
                    self.profile_errors[d.instance] = str(exc) or type(exc).__name__
                    return
                d.flops_bf16 = p.get("flops_bf16", 0.0)
                d.hbm_bw = p.get("hbm_bw", 0.0)
                d.host_to_hbm_bw = p.get("host_to_hbm_bw", 0.0)
                d.hbm_bytes = p.get("hbm_bytes", 0) or d.hbm_bytes
                d.host_ram_bytes = p.get("host_ram_bytes", 0)
                d.chip_kind = p.get("device_kind", d.chip_kind)
                d.chip_count = p.get("local_device_count", 0) or d.chip_count

            await asyncio.gather(*(profile_one(d) for d in devices))

            async def latency_one(d: DeviceInfo, peer: DeviceInfo) -> None:
                body = {"peers": [f"{peer.host}:{peer.grpc_port}"], "payload_sizes": LATENCY_PAYLOAD_SIZES,
                        "rounds": LATENCY_ROUNDS}
                try:
                    lat = (await post(d, "/measure_latency", body))["latency"]
                except (aiohttp.ClientError, asyncio.TimeoutError, KeyError) as exc:
                    log.warning("latency probe from %s failed: %s", d.instance, exc)
                    return
                per_size = next(iter(lat.values()), {})
                if per_size:
                    # the median across payload sizes stands for the hop
                    vals = sorted(per_size.values())
                    d.t_comm = vals[len(vals) // 2]

            if len(devices) > 1:
                await asyncio.gather(*(latency_one(d, devices[(i + 1) % len(devices)])
                                       for i, d in enumerate(devices)))
        return devices

    def head_device(self) -> Optional[DeviceInfo]:
        """Owner of layer 0 in the current topology."""
        if self.current_topology is None:
            return None
        head = self.current_topology.head_instance()
        return next((d for d in self.current_topology.devices if d.instance == head), None)
