"""Ring-mode model lifecycle: the manual topology, the per-shard
/load_model fan-out, and the ring adapter.

Counterpart of dnet_tpu/api/ring_manager.py for single-round contiguous
rings: `build_manual_topology` orders the assignments into a ring and wires
the next pointers; `RingModelManager.load_model` ships each shard its load
body (lanes, speculation and the prefix cache off: 0; weight_quant_bits
as DNET_API_WEIGHT_QUANT_BITS says, or a `<id>:int8` / `<id>:int4` model
id's bits with the base checkpoint as the model path) concurrently and then serves through a `RingApiAdapter`; `_hop_codec` resolves
DNET_WIRE_CODEC=auto per hop.  A failed shard load answers with the
shard's own status (422 for an option the shard does not serve).  An
assignment's `window_size` / `residency_size` ride its body: that shard
streams its weights (core/weights.py).
"""

from __future__ import annotations

import asyncio
import functools
import socket
import time
from typing import List, Optional

import aiohttp

from dnet_tpu_torch.api.inference import EngineCapabilityError
from dnet_tpu_torch.api.model_manager import resolve_model_dir, weight_quant
from dnet_tpu_torch.config import api_settings, wire_settings
from dnet_tpu_torch.core.types import DeviceInfo, LayerAssignment, TopologyInfo
from dnet_tpu_torch.utils.logger import get_logger
from dnet_tpu_torch.utils.tokenizer import load_tokenizer

log = get_logger()

_LOOPBACK_HOSTS = ("127.0.0.1", "::1", "localhost")


@functools.lru_cache(maxsize=256)
def _resolve_host_cached(host: str) -> str:
    try:
        return socket.gethostbyname(host)
    except OSError:
        return host


def build_manual_topology(
    model: str,
    num_layers: int,
    assignments: List[dict],
    devices: List[DeviceInfo],
    kv_bits: int = 0,
) -> TopologyInfo:
    """Order assignments into a ring by min layer, set next pointers, and
    check that they cover every layer exactly once (a shard refuses a
    non-contiguous range at load)."""
    by_instance = {d.instance: d for d in devices}
    las: List[LayerAssignment] = []
    for a in assignments:
        if a["instance"] not in by_instance:
            raise ValueError(f"unknown instance {a['instance']!r}")
        if not a["layers"]:
            raise ValueError(f"empty layer list for {a['instance']!r}")
        las.append(
            LayerAssignment(
                instance=a["instance"],
                layers=sorted(a["layers"]),
                window_size=a.get("window_size", 0),
                residency_size=a.get("residency_size", 0),
                mesh_tp=a.get("mesh_tp", 0),
                mesh_sp=a.get("mesh_sp", 0),
                tp_degree=a.get("tp_degree", 0),
            )
        )
    las.sort(key=lambda a: a.min_layer)
    covered = sorted(layer for a in las for layer in a.layers)
    if covered != list(range(num_layers)):
        raise ValueError(f"assignments must cover layers 0..{num_layers - 1} exactly once; got {covered}")
    for i, a in enumerate(las):
        a.next_instance = las[(i + 1) % len(las)].instance
    return TopologyInfo(
        model=model,
        num_layers=num_layers,
        kv_bits=kv_bits,
        devices=[by_instance[a.instance] for a in las],
        assignments=las,
    )


class ShardLoadError(RuntimeError):
    """A shard refused or failed its load; `status` is its HTTP answer."""

    def __init__(self, message: str, status: int) -> None:
        super().__init__(message)
        self.status = status


class RingModelManager:
    """Drives the shards' /load_model fan-out and owns the ring adapter."""

    engine = None  # no engine in this process

    def __init__(
        self,
        inference,
        cluster_manager,
        models_dir: Optional[str] = None,
        api_callback_addr: str = "",
        max_seq: int = 4096,
        param_dtype: str = "bfloat16",
        request_timeout_s: float = 600.0,
        ring_client_factory=None,
    ) -> None:
        self.inference = inference
        self.cluster = cluster_manager
        self.models_dir = models_dir
        self.api_callback_addr = api_callback_addr  # host:grpc_port for SendToken
        self.max_seq = max_seq
        self.param_dtype = param_dtype
        self.request_timeout_s = request_timeout_s
        self._ring_client_factory = ring_client_factory

    @property
    def current_model_id(self) -> Optional[str]:
        return self.inference.model_id

    def load_bodies(self, topo: TopologyInfo, model_id: str, max_seq: int) -> dict:
        """instance -> its /load_model body; a quant variant's model path
        is its base checkpoint's, its bits the shards' weight_quant_bits."""
        by_instance = {d.instance: d for d in topo.devices}
        model_id, wq, _ = weight_quant(model_id, api_settings())
        bodies = {}
        for a in topo.assignments:
            dev, nxt = by_instance[a.instance], by_instance.get(a.next_instance)
            bodies[a.instance] = {
                "model_path": model_id,
                "layers": a.layers,
                # wired all the way round: the tail's next is the head, which
                # takes the decode-grant continuations
                "next_node": {"host": nxt.host, "grpc_port": nxt.grpc_port},
                "window_size": a.window_size,
                "residency_size": a.residency_size,
                "kv_bits": topo.kv_bits,
                "max_seq_len": max_seq,
                "api_callback_address": f"grpc://{self.api_callback_addr}",
                "param_dtype": self.param_dtype,
                "weight_quant_bits": wq,
                "mesh_tp": a.mesh_tp,
                "mesh_sp": a.mesh_sp,
                "tp_degree": a.tp_degree,
                # not ported on shards (off for every topology, streamed or not)
                "spec_lookahead": 0,
                "lanes": 0,
                "prefix_cache": 0,
                "epoch": topo.epoch,
                "wire_codec": self._hop_codec(dev, nxt, len(topo.assignments)),
            }
        return bodies

    async def load_model(self, model_id: str, max_seq: Optional[int] = None, delta: bool = False) -> float:
        if delta:
            # the reference's delta reload (reuse unchanged shards' weights,
            # bump the epoch) is not ported: refuse before any fan-out
            raise EngineCapabilityError("delta reload is not ported; reload without `delta`")
        topo = self.cluster.current_topology
        if topo is None:
            raise RuntimeError("no topology; POST /v1/prepare_topology_manual first")
        model_dir = resolve_model_dir(weight_quant(model_id, api_settings())[0], self.models_dir)
        if model_dir is None:
            raise FileNotFoundError(f"model {model_id!r} not found locally")
        t0 = time.perf_counter()
        by_instance = {d.instance: d for d in topo.devices}
        max_seq = max_seq or self.max_seq
        bodies = self.load_bodies(topo, model_id, max_seq)
        timeout = aiohttp.ClientTimeout(total=self.request_timeout_s)
        async with aiohttp.ClientSession(timeout=timeout) as session:

            async def ship(a: LayerAssignment) -> None:
                dev = by_instance[a.instance]
                url = f"http://{dev.host}:{dev.http_port}/load_model"
                async with session.post(url, json=bodies[a.instance]) as r:
                    if r.status != 200:
                        text = await r.text()
                        raise ShardLoadError(f"shard {a.instance} load failed ({r.status}): {text}", r.status)

            # shards load concurrently (weight reads dominate); every leg runs
            # to its end before the first failure surfaces
            outcomes = await asyncio.gather(*(ship(a) for a in topo.assignments), return_exceptions=True)
        for exc in outcomes:
            if isinstance(exc, ShardLoadError) and exc.status == 422:
                raise EngineCapabilityError(str(exc))
            if isinstance(exc, BaseException):
                raise exc
        tokenizer = load_tokenizer(model_dir)
        head = self.cluster.head_device()
        from dnet_tpu_torch.api.ring import RingApiAdapter

        old = self.inference.adapter
        adapter = RingApiAdapter(
            head_addr=f"{head.host}:{head.grpc_port}",
            callback_url=f"grpc://{self.api_callback_addr}",
            shard_grpc_addrs=[
                f"{by_instance[a.instance].host}:{by_instance[a.instance].grpc_port}" for a in topo.assignments
            ],
            ring_client_factory=self._ring_client_factory,
            max_seq_len=max_seq,
            auto_steps=api_settings().ring_auto_steps,
            epoch=topo.epoch,
        )
        await adapter.start()
        self.inference.adapter = adapter
        self.inference.tokenizer = tokenizer
        self.inference.model_id = model_id
        if old is not None:
            await old.shutdown()
        dt = time.perf_counter() - t0
        log.info("ring model %s loaded across %d shard(s) in %.1fs (epoch %d)",
                 model_id, len(topo.assignments), dt, topo.epoch)
        return dt

    @staticmethod
    def _canonical_host(host: str) -> str:
        """Best-effort canonical address, so that one machine named once by
        hostname and once by IP is not taken for two hosts."""
        return "127.0.0.1" if host in _LOOPBACK_HOSTS else _resolve_host_cached(host)

    @classmethod
    def _hop_codec(cls, dev: DeviceInfo, nxt: Optional[DeviceInfo], n_shards: int) -> str:
        """This shard's hop codec (DNET_WIRE_CODEC).  `auto` picks qsparse8
        only for hops that cross hosts; a same-host hop keeps the exact
        lossless cast, and a one-shard ring has no hidden hops at all."""
        codec = wire_settings().codec
        if codec != "auto":
            return codec
        if n_shards <= 1 or nxt is None:
            return "lossless"
        same_host = dev.host == nxt.host or cls._canonical_host(dev.host) == cls._canonical_host(nxt.host)
        codec = "lossless" if same_host else "qsparse8"
        log.info("hop codec %s -> %s: %s (%s)", dev.instance, nxt.instance, codec,
                 "same host" if same_host else "crosses hosts")
        return codec
