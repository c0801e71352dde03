"""The ring settings a port ring ships, against the reference's.

DNET_API_RING_LANES, DNET_API_SPEC_LOOKAHEAD and DNET_API_PREFIX_CACHE go
into every shard's /load_model body as the reference's ring manager works
them out (`_lanes_for`, `_spec_lookahead_for`, `_prefix_for`): both
packages' API stacks prepare the same manual topology over recording
shards (in-process HTTP apps that keep each body and answer 200), and the
bodies must carry equal values, including the cases the rules turn off (a
streaming assignment, lanes > 1 turning speculation off, gpt_oss's
rotating cache turning speculation off).  A port shard serves each
shipped setting (lanes: a lane pool of that many rows; spec_lookahead: a
speculating shard; prefix_cache: a snapshot store of that many entries),
and refuses lanes, naming the setting, only where the reference's lane
pool cannot serve: gpt_oss's flat layout (no gated KV writes) and a
streamed shard.  On the shard side
DNET_SHARD_MESH_TP / _SP and DNET_TP are read as the reference's shard
reads them, and refused at load with the setting named.
"""

import asyncio
import importlib

import aiohttp
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.ring]

SETTINGS = ("lanes", "spec_lookahead", "prefix_cache")
STREAMED = {"window_size": 1}


@pytest.fixture
def env(monkeypatch):
    """Set variables for both packages (the reference caches its settings)."""

    def set_env(values: dict):
        for k, v in values.items():
            monkeypatch.setenv(k, v)
        reset_settings_cache()

    yield set_env
    reset_settings_cache()


@pytest.fixture(scope="module")
def tiny_gpt_oss_dir(tmp_path_factory):
    from tests.fakes.checkpoints import make_tiny_gpt_oss

    d = tmp_path_factory.mktemp("oss")
    make_tiny_gpt_oss(d)
    return d


class Peers:
    def __init__(self, devices):
        self.devices = devices

    def peers(self):
        return self.devices


async def _recording_shard(bodies: dict, name: str) -> TestServer:
    async def load(request):
        bodies[name] = await request.json()
        return web.json_response({"status": "ok"})

    async def ok(request):
        return web.json_response({"status": "ok"})

    app = web.Application()
    app.router.add_post("/load_model", load)
    app.router.add_post("/unload_model", ok)
    app.router.add_get("/health", ok)
    srv = TestServer(app)
    await srv.start_server()
    return srv


async def _api_load(pkg: str, model_dir, servers, streamed_tail: bool = False) -> tuple:
    """(status, reply text) of pkg's API stack loading `model_dir` over the
    shard servers [(name, server)] as [0, 1] / [2, 3]."""
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    DeviceInfo = mod("core.types").DeviceInfo
    devices = [DeviceInfo(instance=name, host="127.0.0.1", http_port=srv.port, grpc_port=1 + i)
               for i, (name, srv) in enumerate(servers)]
    inference = mod("api.inference").InferenceManager(adapter=None)
    cluster = mod("api.cluster").ClusterManager(Peers(devices))
    manager = mod("api.ring_manager").RingModelManager(inference, cluster, api_callback_addr="127.0.0.1:9",
                                                       max_seq=64, param_dtype="float32")
    client = TestClient(TestServer(mod("api.http").ApiHTTPServer(inference, manager, cluster).app))
    await client.start_server()
    try:
        tail = dict(STREAMED) if streamed_tail else {}
        r = await client.post("/v1/prepare_topology_manual", json={
            "model": str(model_dir),
            "assignments": [{"instance": "s0", "layers": [0, 1]}, {"instance": "s1", "layers": [2, 3], **tail}]})
        assert r.status == 200, await r.text()
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        return r.status, await r.text()
    finally:
        if inference.adapter is not None:
            await inference.adapter.shutdown()
        await client.close()


def _shipped(model_dir, streamed_tail: bool = False) -> dict:
    """pkg -> instance -> (lanes, spec_lookahead, prefix_cache) its ring
    manager shipped."""

    async def go():
        out = {}
        for pkg in ("dnet_tpu", "dnet_tpu_torch"):
            bodies, servers = {}, []
            for name in ("s0", "s1"):
                servers.append((name, await _recording_shard(bodies, name)))
            try:
                status, text = await _api_load(pkg, model_dir, servers, streamed_tail)
            finally:
                for _, srv in servers:
                    await srv.close()
            assert status == 200, (pkg, text)
            out[pkg] = {name: tuple(b[k] for k in SETTINGS) for name, b in bodies.items()}
        return out

    return asyncio.run(go())


# (environment, streamed tail, the values every shard's body must carry)
CASES = {
    "lanes": ({"DNET_API_RING_LANES": "4"}, False, (4, 0, 0)),
    "lanes-streamed": ({"DNET_API_RING_LANES": "4"}, True, (0, 0, 0)),
    "spec": ({"DNET_API_SPEC_LOOKAHEAD": "4"}, False, (0, 4, 0)),
    "spec-streamed": ({"DNET_API_SPEC_LOOKAHEAD": "4"}, True, (0, 0, 0)),
    "spec-under-lanes": ({"DNET_API_SPEC_LOOKAHEAD": "4", "DNET_API_RING_LANES": "4"}, False, (4, 0, 0)),
    "prefix": ({"DNET_API_PREFIX_CACHE": "4"}, False, (0, 0, 4)),
    "prefix-streamed": ({"DNET_API_PREFIX_CACHE": "4"}, True, (0, 0, 0)),
    "all-off": ({}, False, (0, 0, 0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ring_ships_the_references_settings(tiny_llama_dir, env, case):
    values, streamed, want = CASES[case]
    env(values)
    shipped = _shipped(tiny_llama_dir, streamed)
    assert shipped["dnet_tpu_torch"] == shipped["dnet_tpu"] == {"s0": want, "s1": want}


def test_rotating_cache_turns_ring_speculation_off(tiny_gpt_oss_dir, env):
    """gpt_oss's sliding layers keep a W-row ring (W = 8 < max_seq 64),
    which cannot rewind: both ring managers ship spec_lookahead 0, and the
    port's shards then serve."""
    env({"DNET_API_SPEC_LOOKAHEAD": "4", "DNET_API_PREFIX_CACHE": "2"})
    shipped = _shipped(tiny_gpt_oss_dir)
    assert shipped["dnet_tpu_torch"] == shipped["dnet_tpu"] == {"s0": (0, 0, 2), "s1": (0, 0, 2)}


def _port_body(tiny_llama_dir) -> dict:
    from dnet_tpu_torch.api.ring_manager import RingModelManager, build_manual_topology
    from dnet_tpu_torch.core.types import DeviceInfo

    devices = [DeviceInfo(f"s{i}", "127.0.0.1", 8081 + i, 58081 + i) for i in range(2)]
    topo = build_manual_topology(str(tiny_llama_dir), 4, [{"instance": "s0", "layers": [0, 1]},
                                                          {"instance": "s1", "layers": [2, 3]}], devices)
    return RingModelManager(None, None, api_callback_addr="127.0.0.1:9").load_bodies(topo, str(tiny_llama_dir), 64)


@pytest.mark.parametrize("setting,key", [("DNET_API_RING_LANES", "lanes"),
                                         ("DNET_API_SPEC_LOOKAHEAD", "spec_lookahead"),
                                         ("DNET_API_PREFIX_CACHE", "prefix_cache")])
def test_port_shard_refuses_the_shipped_setting_by_name(tiny_llama_dir, env, setting, key):
    """The shipped value reaches the shard's load.  Each was refused naming
    its setting until it was ported (the case names kept); now lanes load a
    pool of that many lanes, spec_lookahead a shard that speculates
    (`_spec_ok`), prefix_cache a store of that many snapshots."""
    from dnet_tpu_torch.shard.runtime import ShardRuntime

    env({setting: "4"})
    body = _port_body(tiny_llama_dir)["s0"]
    assert body[key] == 4
    opts = {k: body[k] for k in ("kv_bits", "weight_quant_bits", "mesh_tp", "mesh_sp", "tp_degree", *SETTINGS)}
    rt = ShardRuntime("s0", device="cpu")
    rt.load_model_core(str(tiny_llama_dir), body["layers"], max_seq=64, param_dtype="float32", **opts)
    c = rt.compute
    served = {"lanes": c.lane_pool.slots if c.lane_pool else 0,
              "spec_lookahead": c.spec_lookahead if c._spec_ok else 0,
              "prefix_cache": c.prefix_snaps.capacity if c.prefix_snaps is not None else 0}
    assert served == {k: 4 if k == key else 0 for k in SETTINGS}
    rt.unload_model_core()


@pytest.mark.parametrize("case", ["gpt_oss-flat", "streamed"])
def test_port_shard_refuses_lanes_it_cannot_serve(tiny_llama_dir, tiny_gpt_oss_dir, case):
    """lanes=4 on a gpt_oss range whose kinds do not pair (the flat layout:
    no gated KV writes) or on a shard whose weights stream: refused before
    any weight is read, naming DNET_API_RING_LANES and why."""
    from dnet_tpu_torch.shard.compute import ShardCapabilityError
    from dnet_tpu_torch.shard.runtime import ShardRuntime

    model_dir, layers, opts, why = {
        "gpt_oss-flat": (tiny_gpt_oss_dir, [0], {}, "no gated KV writes"),
        "streamed": (tiny_llama_dir, [2, 3], {"window_size": 1}, "resident weights"),
    }[case]
    rt = ShardRuntime("s1", device="cpu")
    with pytest.raises(ShardCapabilityError, match="DNET_API_RING_LANES") as exc:
        rt.load_model_core(str(model_dir), layers, max_seq=64, param_dtype="float32", lanes=4, **opts)
    assert why in str(exc.value) and "lanes=4" in str(exc.value)
    assert rt.compute is None


async def _port_shards():
    from dnet_tpu_torch.shard.adapter import RingAdapter
    from dnet_tpu_torch.shard.http import ShardHTTPServer
    from dnet_tpu_torch.shard.runtime import ShardRuntime
    from dnet_tpu_torch.shard.server import Shard
    from tests.fakes.transport import FakeCallbackClient, FakeRingClient

    shards, servers = [], []
    for name in ("s0", "s1"):
        rt = ShardRuntime(name, device="cpu")
        shard = Shard(name, rt, RingAdapter(rt, ring_client_factory=FakeRingClient,
                                            callback_client_factory=FakeCallbackClient))
        await shard.start()
        srv = TestServer(ShardHTTPServer(shard).app)
        await srv.start_server()
        shards.append(shard)
        servers.append((name, srv))
    return shards, servers


def test_port_api_answers_422_naming_ring_lanes(tiny_llama_dir, env):
    """DNET_API_RING_LANES=4 on a port ring of two port shards: the API
    ships lanes 4.  Refused (422 naming the setting) until lanes were
    ported, which it checks now (the name kept): the load answers 200 and
    each shard holds a pool of 4 lanes."""
    env({"DNET_API_RING_LANES": "4"})

    async def go():
        shards, servers = await _port_shards()
        try:
            status, text = await _api_load("dnet_tpu_torch", tiny_llama_dir, servers)
            return status, text, [s.runtime.compute.lane_pool.slots for s in shards]
        finally:
            for shard, (_, srv) in zip(shards, servers):
                await srv.close()
                await shard.stop()

    status, text, slots = asyncio.run(go())
    assert status == 200, text
    assert slots == [4, 4]


@pytest.mark.parametrize("setting", ["DNET_SHARD_MESH_TP", "DNET_SHARD_MESH_SP", "DNET_TP"])
def test_port_shard_reads_and_refuses_mesh_and_tp_settings(tiny_llama_dir, env, setting):
    """A load body with mesh_tp / mesh_sp / tp_degree 0 takes the shard's
    own DNET_SHARD_MESH_TP / _SP and DNET_TP, as the reference's shard
    does; a value above 1 answers 422 naming it."""
    env({setting: "2"})

    async def go():
        shards, servers = await _port_shards()
        try:
            async with aiohttp.ClientSession() as session:
                r = await session.post(f"http://127.0.0.1:{servers[0][1].port}/load_model", json={
                    "model_path": str(tiny_llama_dir), "layers": [0, 1], "max_seq_len": 64,
                    "param_dtype": "float32"})
                return r.status, await r.text(), shards[0].runtime.compute
        finally:
            for shard, (_, srv) in zip(shards, servers):
                await srv.close()
                await shard.stop()

    status, text, compute = asyncio.run(go())
    assert status == 422, text
    assert setting in text and "=2" in text
    assert compute is None
