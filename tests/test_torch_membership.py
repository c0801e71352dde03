"""The port's membership (dnet_tpu_torch/membership/) against the
reference's: epochs, the stale-epoch fence at its three sites, delta
planning, the quarantine list, and a delta reload through the shards'
POST /update_topology, driven by either package's API stack.

The cases follow tests/subsystems/test_membership.py; each runs on both
packages, which must agree."""

import asyncio
import importlib
import types

import pytest

from tests.fakes.transport import FakeCallbackClient, FakeRingClient

pytestmark = pytest.mark.api

PKGS = ["dnet_tpu", "dnet_tpu_torch"]


def _pkg(name: str) -> types.SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        membership=mod("membership"), types=mod("core.types"), obs=mod("obs"), chaos=mod("resilience.chaos"),
        cluster=mod("api.cluster"), ring=mod("api.ring"), adapter=mod("shard.adapter"),
        runtime=mod("shard.runtime"), servicer=mod("shard.grpc_servicer"), proto=mod("transport.protocol"),
        name=name,
    )


@pytest.fixture(params=PKGS)
def pkg(request):
    p = _pkg(request.param)
    p.chaos.clear_chaos()
    yield p
    p.chaos.clear_chaos()


def _stale(p, kind: str) -> float:
    return p.obs.metric("dnet_stale_epoch_rejected_total").labels(kind=kind).value


def _topo(p, n=2):
    T = p.types
    devs = [T.DeviceInfo(instance=f"s{i}", host=f"h{i}", http_port=1, grpc_port=10 + i) for i in range(n)]
    las = [T.LayerAssignment(instance=f"s{i}", layers=[2 * i, 2 * i + 1], next_instance=f"s{(i + 1) % n}")
           for i in range(n)]
    return T.TopologyInfo(model="m", num_layers=2 * n, kv_bits=0, devices=devs, assignments=las)


def test_epoch_primitives_equal_the_reference():
    ref, port = _pkg("dnet_tpu"), _pkg("dnet_tpu_torch")
    assert port.membership.STALE_EPOCH_KINDS == ref.membership.STALE_EPOCH_KINDS
    assert port.membership.RECOVERY_OUTCOMES == ref.membership.RECOVERY_OUTCOMES

    def clock_run(p):
        c = p.membership.EpochClock()
        out = [c.mint(), c.mint()]
        c.observe(10)
        out.append(c.mint())
        c.observe(3)
        return out + [c.mint(), c.current]

    assert clock_run(port) == clock_run(ref) == [1, 2, 11, 12, 12]
    pairs = [(0, 5), (5, 0), (3, 3), (3, 2), (2, 3), (0, 0)]
    assert [port.membership.is_stale(h, g) for h, g in pairs] == [ref.membership.is_stale(h, g) for h, g in pairs]


@pytest.mark.parametrize("kind", ["frame", "token_cb", "reset_cache"])
def test_reject_counts_and_types_its_error(pkg, kind):
    before = _stale(pkg, kind)
    err = pkg.membership.reject(kind, 4, 3)
    assert isinstance(err, pkg.membership.StaleEpochError)
    assert (err.kind, err.held, err.got) == (kind, 4, 3)
    assert str(err) == f"stale epoch: {kind} carries epoch 3, holder is at epoch 4"
    assert _stale(pkg, kind) - before == 1


def test_cluster_manager_mints_on_install_and_restores(pkg):
    cm = pkg.cluster.ClusterManager(discovery=None)
    gauge = pkg.obs.metric("dnet_topology_epoch")
    t1, t2 = _topo(pkg), _topo(pkg)
    cm.install_topology(t1)
    cm.install_topology(t2)
    assert (t1.epoch, t2.epoch, cm.epoch, gauge.value) == (1, 2, 2, 2.0)
    cm.restore_topology(t1)  # a failed reload: the old epoch comes back
    assert (cm.epoch, gauge.value) == (1, 1.0)
    t3 = _topo(pkg)
    cm.install_topology(t3)
    assert t3.epoch == 3  # the aborted epoch is never reused


BODIES = [
    {"layers": [0, 1], "epoch": 1, "next_node": {"host": "a"}, "lanes": 0},
    {"layers": [0, 1], "epoch": 9, "next_node": {"host": "z"}, "lanes": 0},
    {"layers": [0, 1, 2], "epoch": 1, "next_node": {"host": "a"}, "lanes": 0},
    {"layers": [0, 1], "lanes": 0, "kv_bits": 8},
    {"model_path": "/m", "layers": [2, 3], "max_seq_len": 64, "epoch": 3},
]


def test_delta_planning_equals_the_reference():
    ref, port = _pkg("dnet_tpu").membership, _pkg("dnet_tpu_torch").membership
    assert [port.body_signature(b) for b in BODIES] == [ref.body_signature(b) for b in BODIES]
    assert port.body_signature(BODIES[0]) == port.body_signature(BODIES[1])
    assert port.body_signature(BODIES[0]) != port.body_signature(BODIES[2])
    for last_keys in ([], [0], [0, 3], [1, 2, 4]):
        last = {f"s{i}": ref.body_signature(BODIES[i]) for i in last_keys}
        bodies = {f"s{i}": BODIES[(i + 1) % len(BODIES)] for i in range(5)} | {"s0": BODIES[1]}
        got = port.split_delta(last, bodies)
        want = ref.split_delta(last, bodies)
        assert (set(got[0]), set(got[1])) == (set(want[0]), set(want[1]))


def test_quarantine_stability_window_and_defer(pkg):
    qs = pkg.membership.QuarantineSet()
    dev = pkg.types.DeviceInfo(instance="s1", host="h", http_port=1, grpc_port=2)
    q = qs.add(dev)
    assert "s1" in qs and not qs.ready(0.0) and q.addr == "h:2"
    q.mark_green(now=100.0)
    q.mark_green(now=105.0)
    assert q.stable_for(now=107.0) == pytest.approx(7.0) and q.probes_ok == 2
    assert qs.ready(5.0, now=107.0) == [q]
    q.mark_red("probe lost")  # one red probe resets the window
    assert q.stable_for(now=200.0) == 0.0 and not qs.ready(0.0, now=200.0)
    q.mark_green(now=300.0)
    q.defer(now=305.0)  # a failed rejoin: the window is earned again
    assert q.stable_for(now=306.0) == pytest.approx(1.0)
    assert qs.add(dev) is q and q.last_error == "re-quarantined"
    assert set(qs.snapshot()["s1"]) == {"quarantined_s", "green_s", "probes_ok", "last_error"}
    assert qs.remove("s1") is q and "s1" not in qs and not qs


# ---- the three fences --------------------------------------------------------


def _shard(p, epoch):
    rt = p.runtime.ShardRuntime("s")
    rt.set_epoch(epoch)
    adapter = p.adapter.RingAdapter(rt, ring_client_factory=lambda a: FakeRingClient(a),
                                    callback_client_factory=lambda a: FakeCallbackClient(a))
    return rt, adapter


def _frame(p, epoch, seq=0):
    return p.proto.ActivationFrame(nonce="n", seq=seq, layer_id=-1, pos=0, dtype="tokens", shape=(1, 1),
                                   payload=b"\x01\x00\x00\x00", epoch=epoch)


def test_shard_ingress_fences_a_stale_frame(pkg):
    async def go():
        rt, adapter = _shard(pkg, 2)
        adapter.configure_topology("next:1")
        before = _stale(pkg, "frame")
        ok, msg = await adapter.ingress_frame(_frame(pkg, 1))
        assert not ok and msg == "stale epoch: frame carries epoch 1, holder is at epoch 2"
        for seq, good in enumerate((2, 0), start=1):  # same and unfenced epochs pass (and relay)
            assert await adapter.ingress_frame(_frame(pkg, good, seq)) == (True, "relayed")
        assert _stale(pkg, "frame") - before == 1
        await adapter.shutdown()
        return msg

    asyncio.run(go())


def test_zombie_frame_chaos_point_forces_rejection(pkg):
    async def go():
        rt, adapter = _shard(pkg, 3)
        before = _stale(pkg, "frame")
        injected = pkg.obs.metric("dnet_chaos_injected_total").labels(point="zombie_frame")
        n0 = injected.value
        pkg.chaos.install_chaos("zombie_frame:error:1.0", seed=3)
        try:
            ok, msg = await adapter.ingress_frame(_frame(pkg, 3))
        finally:
            pkg.chaos.clear_chaos()
        assert not ok and "stale epoch" in msg
        assert (_stale(pkg, "frame") - before, injected.value - n0) == (1, 1)
        await adapter.shutdown()

    asyncio.run(go())


def test_reset_cache_is_fenced_by_epoch(pkg):
    async def go():
        rt, adapter = _shard(pkg, 2)
        servicer = pkg.servicer.ShardRingServicer(adapter, rt)
        before = _stale(pkg, "reset_cache")
        with pytest.raises(pkg.membership.StaleEpochError):
            await servicer.reset_cache(pkg.proto.ResetCacheRequest(nonce="n", epoch=1), None)
        await servicer.reset_cache(pkg.proto.ResetCacheRequest(nonce="n", epoch=2), None)
        await servicer.reset_cache(pkg.proto.ResetCacheRequest(nonce="n", epoch=0), None)
        assert _stale(pkg, "reset_cache") - before == 1
        assert (await servicer.health_check(None, None)).epoch == 2
        probe = await servicer.measure_latency(pkg.proto.LatencyProbe(t_sent=1.5, payload=b"xy"), None)
        assert (probe.t_sent, probe.payload) == (1.5, b"xy") and probe.t_remote > 0
        await adapter.shutdown()

    asyncio.run(go())


def test_api_drops_a_zombie_token_callback(pkg):
    async def go():
        adapter = pkg.ring.RingApiAdapter(head_addr="h:1", callback_url="grpc://api:1",
                                          ring_client_factory=lambda a: FakeRingClient(a), epoch=2)
        fut = adapter._futures.expect("r1", 0)
        before = _stale(pkg, "token_cb")
        adapter.resolve_token(pkg.types.TokenResult(nonce="r1", token_id=999, step=0, epoch=1))
        await asyncio.sleep(0)
        assert not fut.done()  # the zombie token resolved nothing
        adapter.resolve_token(pkg.types.TokenResult(nonce="r1", token_id=7, step=0, epoch=2))
        await asyncio.sleep(0)
        assert fut.done() and fut.result().token_id == 7
        assert _stale(pkg, "token_cb") - before == 1
        # the monitor's fast-fail resolves what is still pending, with the error
        fut2 = adapter._futures.expect("r2", 3)
        adapter.fail_pending("shard s1 is unreachable")
        await asyncio.sleep(0)
        assert fut2.result().error == "shard s1 is unreachable" and fut2.result().step == 3

    asyncio.run(go())


def test_shard_update_topology_endpoint(tiny_llama_dir):
    """The port shard's POST /update_topology: 409 without proof of holding
    the model and layers; with it, the epoch and next hop change, the
    weights stay (the same engine) and the per-request state goes."""
    from aiohttp.test_utils import TestClient, TestServer

    from dnet_tpu_torch.shard.http import ShardHTTPServer, ShardLoadModelRequest
    from dnet_tpu_torch.shard.server import Shard

    port = _pkg("dnet_tpu_torch")

    async def go():
        rt, adapter = _shard(port, 0)
        rt.device = "cpu"
        shard = Shard("s0", rt, adapter)
        await shard.start()
        client = TestClient(TestServer(ShardHTTPServer(shard).app))
        await client.start_server()
        body = {"model_path": str(tiny_llama_dir), "layers": [0, 1, 2, 3]}
        try:
            assert (await client.post("/update_topology", json=dict(body, epoch=9))).status == 409
            await shard.load_model(ShardLoadModelRequest(**body, max_seq_len=64, param_dtype="float32", epoch=5))
            engine = rt.compute.engine
            rt.compute.engine.new_session("stale", None)
            for wrong in ({"layers": [0, 1]}, {"model_path": "/nonexistent/model"}):
                r = await client.post("/update_topology", json=dict(body, epoch=6, **wrong))
                assert r.status == 409
            assert rt.epoch == 5
            r = await client.post("/update_topology",
                                  json=dict(body, epoch=6, next_node={"host": "peer", "grpc_port": 7}))
            assert r.status == 200 and await r.json() == {"status": "ok", "epoch": 6}
            assert (rt.epoch, adapter.next_addr, rt.compute.engine is engine) == (6, "peer:7", True)
            assert len(rt.compute.engine.sessions) == 0
            assert (await (await client.get("/health")).json())["epoch"] == 6
            assert port.obs.metric("dnet_topology_epoch").value == 6.0
        finally:
            await client.close()
            await shard.stop()

    asyncio.run(go())
