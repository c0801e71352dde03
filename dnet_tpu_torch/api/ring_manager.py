"""Ring-mode model lifecycle: the manual topology, the per-shard
/load_model fan-out, and the ring adapter.

Counterpart of dnet_tpu/api/ring_manager.py: `build_manual_topology`
orders the assignments into a ring, wires the next pointers and splits
each assignment into its rounds (a non-contiguous one is a k-round
schedule: each contiguous run is one visit of the activation a token);
`RingModelManager.load_model` ships each shard its load body concurrently
and then serves through a `RingApiAdapter` (with the ring prefix cache
when the bodies carry one).  The body carries weight_quant_bits as
DNET_API_WEIGHT_QUANT_BITS says (or a `<id>:int8` / `<id>:int4` model id's
bits, with the base checkpoint as the model path), and lanes,
spec_lookahead and prefix_cache as the reference's rules work them out
from DNET_API_RING_LANES, DNET_API_SPEC_LOOKAHEAD and
DNET_API_PREFIX_CACHE (`_lanes_for`, `_spec_lookahead_for`, `_prefix_for`:
each needs a single-round resident topology, lanes a model with gated KV
writes, speculation a rewindable cache and no lanes; every setting they
turn off is logged).  `_hop_codec` resolves
DNET_WIRE_CODEC=auto per hop.  A failed shard load answers with the
shard's own status (422 for an option the shard does not serve).  An
assignment's `window_size` / `residency_size` ride its body: that shard
streams its weights (core/weights.py).  `load_model(delta=True)` is the
reference's delta reload (membership/delta.py): a shard whose body is
unchanged since its last load (all but `epoch` and `next_node`) keeps its
weights and takes only the new epoch and next hop through POST
/update_topology; a shard that refuses it (409: it no longer holds the
model) is loaded in full.  The resolved max_seq is kept, so that a
recovery's reload reproduces the last load's bodies.
"""

from __future__ import annotations

import asyncio
import functools
import json
import socket
import time
from pathlib import Path
from typing import List, Optional

import aiohttp

from dnet_tpu_torch.api.inference import EngineCapabilityError
from dnet_tpu_torch.api.model_manager import resolve_model_dir, weight_quant
from dnet_tpu_torch.config import api_settings, wire_settings
from dnet_tpu_torch.core.types import DeviceInfo, LayerAssignment, TopologyInfo
from dnet_tpu_torch.membership import body_signature, split_delta
from dnet_tpu_torch.shard.compute import contiguous_runs
from dnet_tpu_torch.utils.logger import get_logger
from dnet_tpu_torch.utils.network import primary_ip
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
    """Order assignments into a ring by min layer, set next pointers and
    each assignment's rounds, and check that they cover every layer
    exactly once."""
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
    # a frame for a layer a shard does not own relays along the next
    # pointers, so exact coverage is all a k-round schedule needs
    for a in las:
        a.rounds = contiguous_runs(a.layers)
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
        callback_port: int = 0,
        max_seq: int = 4096,
        param_dtype: str = "bfloat16",
        request_timeout_s: float = 600.0,
        ring_client_factory=None,
    ) -> None:
        self.inference = inference
        self.cluster = cluster_manager
        self.models_dir = models_dir
        # host:grpc_port the shards dial for SendToken; empty: this host's
        # address facing each load's shards, on callback_port
        self.api_callback_addr = api_callback_addr
        self.callback_port = callback_port
        self.max_seq = max_seq
        self.param_dtype = param_dtype
        self.request_timeout_s = request_timeout_s
        self._ring_client_factory = ring_client_factory
        # instance -> signature of the body it last loaded in full: what a
        # delta reload may skip
        self._last_load: dict = {}

    @property
    def current_model_id(self) -> Optional[str]:
        return self.inference.model_id

    @property
    def weight_quant_bits(self) -> int:
        """The shards' weight_quant_bits for the loaded model (the solver's
        memory model)."""
        return weight_quant(self.inference.model_id or "", api_settings())[1]

    def callback_address(self, topo: TopologyInfo) -> str:
        """host:port of the API's token callback: the address set, else the
        interface facing the topology's shards.  Resolved at each load, not
        at start-up: a discovered peer table is still empty then, and an
        empty table resolves to loopback, which no other host reaches."""
        if self.api_callback_addr:
            return self.api_callback_addr
        return f"{primary_ip(d.host for d in topo.devices)}:{self.callback_port}"

    def load_bodies(self, topo: TopologyInfo, model_id: str, max_seq: int) -> dict:
        """instance -> its /load_model body; a quant variant's model path
        is its base checkpoint's, its bits the shards' weight_quant_bits."""
        by_instance = {d.instance: d for d in topo.devices}
        model_id, wq, _ = weight_quant(model_id, api_settings())
        model_dir = resolve_model_dir(model_id, self.models_dir)
        lanes = self._lanes_for(topo, model_dir)
        spec = 0 if lanes > 1 else self._spec_lookahead_for(topo, model_dir, max_seq)
        prefix = self._prefix_for(topo)
        callback = self.callback_address(topo)
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
                "api_callback_address": f"grpc://{callback}",
                "param_dtype": self.param_dtype,
                "weight_quant_bits": wq,
                "mesh_tp": a.mesh_tp,
                "mesh_sp": a.mesh_sp,
                "tp_degree": a.tp_degree,
                "spec_lookahead": spec,
                "lanes": lanes,
                "prefix_cache": prefix,
                "epoch": topo.epoch,
                "wire_codec": self._hop_codec(dev, nxt, len(topo.assignments)),
            }
        return bodies

    @staticmethod
    def _single_round_resident(topo: TopologyInfo) -> bool:
        """The precondition lanes, the prefix cache and speculation share:
        every assignment one contiguous run (the prompt visits each shard
        once) with no streaming window."""
        return all(a.layers == list(range(a.layers[0], a.layers[-1] + 1)) and a.window_size <= 0
                   for a in topo.assignments)

    @staticmethod
    def _probe_model(model_dir):
        """(ModelConfig, ring model class) from a checkpoint's config.json."""
        from dnet_tpu_torch.models import ModelConfig, get_ring_model_cls

        cfg = ModelConfig.from_hf(json.loads((Path(model_dir) / "config.json").read_text()))
        return cfg, get_ring_model_cls(cfg.model_type)

    def _lanes_for(self, topo: TopologyInfo, model_dir) -> int:
        """DNET_API_RING_LANES where the topology is single-round and
        resident and the model has gated KV writes, else 0 (logged)."""
        lanes = api_settings().ring_lanes
        if lanes <= 1:
            return 0
        if not self._single_round_resident(topo):
            log.info("ring lanes off: k-round or streaming topology")
            return 0
        try:
            cfg, model_cls = self._probe_model(model_dir)
        except Exception as exc:  # an unreadable model serves single-lane
            log.warning("ring lanes off (model probe failed: %s); serving lanes=1", exc)
            return 0
        if not model_cls.supports_kv_commit:
            log.warning("ring_lanes=%d requested but %s has no gated KV writes; degrading to lanes=1",
                        lanes, cfg.model_type)
            return 0
        return lanes

    def _prefix_for(self, topo: TopologyInfo) -> int:
        """DNET_API_PREFIX_CACHE where the topology is single-round and
        resident, else 0 (logged)."""
        cap = api_settings().prefix_cache
        if cap <= 0:
            return 0
        if not self._single_round_resident(topo):
            log.info("ring prefix cache off: k-round or streaming topology")
            return 0
        return cap

    def _spec_lookahead_for(self, topo: TopologyInfo, model_dir, max_seq: int) -> int:
        """DNET_API_SPEC_LOOKAHEAD where the topology is single-round and
        resident and the whole model's cache can rewind at max_seq (no
        rotating ring), else 0 (logged)."""
        lookahead = api_settings().spec_lookahead
        if lookahead <= 0:
            return 0
        if not self._single_round_resident(topo):
            log.info("ring speculation off: k-round or streaming topology")
            return 0
        try:
            cfg, model_cls = self._probe_model(model_dir)
            if not model_cls(cfg, range(cfg.num_hidden_layers), "cpu").kv_rewindable(max_seq):
                log.info("ring speculation off: %s cache cannot rewind", cfg.model_type)
                return 0
        except Exception as exc:
            log.warning("ring speculation off (model probe failed: %s)", exc)
            return 0
        return lookahead

    async def load_model(self, model_id: str, max_seq: Optional[int] = None, delta: bool = False) -> float:
        topo = self.cluster.current_topology
        if topo is None:
            raise RuntimeError("no topology; POST /v1/prepare_topology_manual first")
        model_dir = resolve_model_dir(weight_quant(model_id, api_settings())[0], self.models_dir)
        if model_dir is None:
            raise FileNotFoundError(f"model {model_id!r} not found locally")
        t0 = time.perf_counter()
        by_instance = {d.instance: d for d in topo.devices}
        # a recovery reload passes no max_seq and must reproduce the last
        # load's bodies (another max_seq would make every shard "changed")
        self.max_seq = max_seq = max_seq or self.max_seq
        bodies = self.load_bodies(topo, model_id, max_seq)
        first = next(iter(bodies.values()), {})
        lanes, prefix = first.get("lanes", 0), first.get("prefix_cache", 0)
        changed, unchanged = split_delta(self._last_load, bodies) if delta else (bodies, {})
        timeout = aiohttp.ClientTimeout(total=self.request_timeout_s)
        async with aiohttp.ClientSession(timeout=timeout) as session:

            async def ship(a: LayerAssignment) -> None:
                """One shard's leg: the delta update where its body is
                unchanged, the full /load_model otherwise."""
                dev, body = by_instance[a.instance], bodies[a.instance]
                if a.instance in unchanged:
                    if await self._update_topology(session, dev, body):
                        return
                    log.warning("delta update of %s refused; falling back to a full load", a.instance)
                url = f"http://{dev.host}:{dev.http_port}/load_model"
                async with session.post(url, json=body) as r:
                    if r.status != 200:
                        # a half-shipped topology must not leave a signature
                        # claiming this shard can be delta-updated
                        self._last_load.pop(a.instance, None)
                        text = await r.text()
                        raise ShardLoadError(f"shard {a.instance} load failed ({r.status}): {text}", r.status)
                self._last_load[a.instance] = body_signature(body)

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
            callback_url=f"grpc://{self.callback_address(topo)}",
            shard_grpc_addrs=[
                f"{by_instance[a.instance].host}:{by_instance[a.instance].grpc_port}" for a in topo.assignments
            ],
            ring_client_factory=self._ring_client_factory,
            max_seq_len=max_seq,
            auto_steps=api_settings().ring_auto_steps,
            lanes=max(lanes, 1),
            prefix_cache=prefix,
            epoch=topo.epoch,
        )
        await adapter.start()
        self.inference.adapter = adapter
        # each shard's lane pool holds exactly `lanes` rows: admission queues
        # the requests beyond them instead of failing them at a shard
        self.inference.admission.set_capacity(lanes if lanes > 1 else None)
        self.inference.tokenizer = tokenizer
        self.inference.model_id = model_id
        if old is not None:
            await old.shutdown()
        dt = time.perf_counter() - t0
        log.info("ring model %s loaded across %d shard(s) in %.1fs (epoch %d, %d full load(s), %d delta update(s))",
                 model_id, len(topo.assignments), dt, topo.epoch, len(changed), len(unchanged))
        return dt

    async def _update_topology(self, session, dev: DeviceInfo, body: dict) -> bool:
        """One shard's POST /update_topology; False (a refusal or a transport
        failure) sends the caller to the full load."""
        url = f"http://{dev.host}:{dev.http_port}/update_topology"
        payload = {k: body[k] for k in ("model_path", "layers", "epoch", "next_node")}
        try:
            async with session.post(url, json=payload) as r:
                if r.status == 200:
                    return True
                log.warning("update_topology on %s answered %d: %s", dev.instance, r.status, await r.text())
        except (aiohttp.ClientError, asyncio.TimeoutError) as exc:
            log.warning("update_topology on %s failed: %s", dev.instance, exc)
        return False

    async def unload_model(self) -> None:
        """Drop the model: stop the ring adapter and ask every shard of the
        topology to unload (concurrently; a failed leg is logged)."""
        topo = self.cluster.current_topology
        self._last_load.clear()  # unloaded shards hold nothing to delta from
        self.inference.model_id = None
        self.inference.tokenizer = None
        adapter, self.inference.adapter = self.inference.adapter, None
        if adapter is not None:
            await adapter.shutdown()
        if topo is None:
            return
        by_instance = {d.instance: d for d in topo.devices}
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=60.0)) as session:

            async def drop(a: LayerAssignment) -> None:
                dev = by_instance[a.instance]
                try:
                    async with session.post(f"http://{dev.host}:{dev.http_port}/unload_model") as r:
                        await r.read()
                except (aiohttp.ClientError, asyncio.TimeoutError) as exc:
                    log.warning("unload on %s failed: %s", a.instance, exc)

            await asyncio.gather(*(drop(a) for a in topo.assignments))

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
