"""Request deadlines and `delta` reloads: the port's HTTP server against
dnet_tpu's on the same tiny checkpoint.  A request already past its
deadline is shed with 429 and Retry-After, one whose deadline passes
between decode steps ends with 504 (or an in-band error event once the
stream has started), `deadline_s <= 0` is an invalid request, and
`/v1/load_model {"delta": true}` is refused with 400 on a single process
and served on a ring as the reference's ring serves it.  Bodies must match
byte for byte once `id` and `created` are normalized."""

import asyncio
import json
import re
import time
import types

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

CHAT = {
    "model": "tiny",
    "messages": [{"role": "user", "content": "Hello there"}],
    "max_tokens": 8,
    "temperature": 0,
}


@pytest.fixture
def no_warmup(monkeypatch):
    # the reference would otherwise compile every decode-chunk width at load
    monkeypatch.setenv("DNET_API_WARM_ON_LOAD", "0")
    monkeypatch.delenv("DNET_REQUEST_DEADLINE_S", raising=False)
    reset_settings_cache()
    yield
    reset_settings_cache()


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


def _apps():
    """(name, app, inference manager, admission controller module) of the
    reference's server and the port's."""
    import dnet_tpu.admission.controller as ref_ctl
    import dnet_tpu_torch.admission.controller as port_ctl
    from dnet_tpu.api.http import ApiHTTPServer as RefServer
    from dnet_tpu.api.inference import InferenceManager as RefInference
    from dnet_tpu.api.model_manager import LocalModelManager as RefManager
    from dnet_tpu_torch.api.http import ApiHTTPServer
    from dnet_tpu_torch.api.inference import InferenceManager
    from dnet_tpu_torch.api.model_manager import LocalModelManager

    ref = RefInference(adapter=None, request_timeout_s=120.0, max_concurrent=2)
    port = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=2)
    return [
        ("ref", RefServer(ref, RefManager(ref, max_seq=64, param_dtype="float32")).app, ref, ref_ctl),
        ("port", ApiHTTPServer(port, LocalModelManager(port, max_seq=64, param_dtype="float32",
                                                         device="cpu")).app, port, port_ctl),
    ]


async def _serve(app, model_dir, requests, after_load=None):
    """Load the model, run `after_load()`, then send each (path, body);
    returns (status, Retry-After, normalized body) per request."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        assert r.status == 200, await r.text()
        if after_load is not None:
            after_load()
        out = []
        for path, body in requests:
            resp = await client.post(path, json=body)
            out.append((resp.status, resp.headers.get("Retry-After"), _normalize((await resp.read()).decode())))
        return out
    finally:
        await client.close()


def _both(model_dir, requests, hook=None):
    """Each server's answers; `hook(name, inference, controller module)`
    runs after its load."""
    out = {}
    for name, app, inference, ctl in _apps():
        after = None if hook is None else (lambda n=name, i=inference, c=ctl: hook(n, i, c))
        out[name] = asyncio.run(_serve(app, model_dir, requests, after))
    return out["ref"], out["port"]


def test_expired_on_arrival_is_shed_with_the_reference_429(tiny_llama_dir, no_warmup):
    requests = [
        ("/v1/chat/completions", dict(CHAT, deadline_s=1e-6)),
        ("/v1/chat/completions", dict(CHAT, deadline_s=1e-6, stream=True)),
        ("/v1/completions", {"model": "tiny", "prompt": "abc", "max_tokens": 4, "deadline_s": 1e-6}),
        # a live deadline changes nothing
        ("/v1/chat/completions", dict(CHAT, deadline_s=600.0)),
    ]
    ref, port = _both(tiny_llama_dir, requests)
    assert port == ref
    for status, retry_after, body in port[:3]:
        assert status == 429 and retry_after == "1"
        assert json.loads(body) == {
            "error": {"message": "request deadline already expired", "type": "rate_limit_exceeded"}
        }
    assert port[3][0] == 200


def test_env_default_deadline_applies_and_a_request_overrides_it(tiny_llama_dir, no_warmup, monkeypatch):
    monkeypatch.setenv("DNET_REQUEST_DEADLINE_S", "1e-6")
    reset_settings_cache()
    requests = [
        ("/v1/chat/completions", CHAT),
        ("/v1/chat/completions", dict(CHAT, stream=True)),
        ("/v1/chat/completions", dict(CHAT, deadline_s=600.0)),
    ]
    ref, port = _both(tiny_llama_dir, requests)
    assert port == ref
    assert [s for s, _, _ in port] == [429, 429, 200]


@pytest.mark.parametrize("deadline_s", [0, -1.5])
def test_nonpositive_deadline_is_an_invalid_request(tiny_llama_dir, no_warmup, deadline_s):
    requests = [
        ("/v1/chat/completions", dict(CHAT, deadline_s=deadline_s)),
        ("/v1/completions", {"model": "tiny", "prompt": "abc", "deadline_s": deadline_s}),
    ]
    ref, port = _both(tiny_llama_dir, requests)
    assert port == ref
    for status, _, body in port:
        assert status == 400
        assert json.loads(body)["error"]["message"].startswith("invalid request: ")


def _lapse_after_step(step_at: int):
    """A hook that lets a deadline lapse once the token of `step_at` has
    been awaited: the controller module's wall clock jumps a day ahead
    (again for each request)."""

    def hook(name, inference, ctl):
        offset = [0.0]
        fake = types.SimpleNamespace(time=lambda: time.time() + offset[0], monotonic=time.monotonic)
        ctl.time = fake
        adapter = inference.adapter
        await_token = adapter.await_token

        async def slowed(nonce, step, timeout):
            result = await await_token(nonce, step, timeout)
            if step == step_at:
                offset[0] += 86400.0
            return result

        adapter.await_token = slowed

    return hook


def test_deadline_lapsing_mid_stream_matches_the_reference(tiny_llama_dir, no_warmup, monkeypatch):
    import dnet_tpu.admission.controller as ref_ctl
    import dnet_tpu_torch.admission.controller as port_ctl

    monkeypatch.setattr(ref_ctl, "time", time)
    monkeypatch.setattr(port_ctl, "time", time)
    requests = [
        ("/v1/chat/completions", dict(CHAT, deadline_s=600.0, stream=True)),
        ("/v1/chat/completions", dict(CHAT, deadline_s=600.0)),
    ]
    ref, port = _both(tiny_llama_dir, requests, _lapse_after_step(2))
    assert port == ref
    (s_stream, _, stream), (s_agg, _, agg) = port
    # streamed: three tokens' chunks, then the in-band error and no [DONE]
    assert s_stream == 200
    events = [ln[len("data: "):] for ln in stream.splitlines() if ln.startswith("data: ")]
    assert "[DONE]" not in events and len(events) >= 2
    assert json.loads(events[-1]) == {
        "error": {"message": "request deadline expired after 3 token(s)", "type": "deadline_exceeded"}
    }
    assert s_agg == 504
    assert json.loads(agg)["error"]["type"] == "deadline_exceeded"


def test_delta_reload_refused_on_a_single_process(tiny_llama_dir, no_warmup):
    ref, port = _both(tiny_llama_dir, [("/v1/load_model", {"model": str(tiny_llama_dir), "delta": True})])
    assert port == ref
    assert port[0][0] == 400
    assert json.loads(port[0][2])["error"]["message"] == "delta reload is only available in ring mode"


def test_delta_reload_refused_on_a_port_ring(tiny_llama_dir):
    """A delta reload on a ring of two port shards, driven by the port's
    API stack and by the reference's: after a full load and a re-installed
    topology, `/v1/load_model {"delta": true}` loads no shard again (each
    takes /update_topology and keeps its engine), every shard holds the
    new epoch (+1), and both APIs answer the same statuses and keys."""
    from dnet_tpu_torch.shard.adapter import RingAdapter
    from dnet_tpu_torch.shard.http import ShardHTTPServer
    from dnet_tpu_torch.shard.runtime import ShardRuntime
    from dnet_tpu_torch.shard.server import Shard
    from tests.fakes.transport import FakeCallbackClient, FakeRingClient

    class Peers:
        def __init__(self, devices):
            self.devices = devices

        def peers(self):
            return self.devices

    async def api_run(pkg, shards, servers):
        import importlib

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
        out = []
        try:
            topo = {"model": str(tiny_llama_dir), "assignments": [{"instance": "s0", "layers": [0, 1]},
                                                                  {"instance": "s1", "layers": [2, 3]}]}
            for route, body in (("/v1/prepare_topology_manual", topo), ("/v1/load_model", {"model": topo["model"]}),
                                ("/v1/prepare_topology_manual", topo),
                                ("/v1/load_model", {"model": topo["model"], "delta": True})):
                engines = [rt.compute.engine if rt.compute else None for rt, _ in shards]
                r = await client.post(route, json=body)
                reply = await r.json()
                kept = [rt.compute is not None and rt.compute.engine is e for (rt, _), e in zip(shards, engines)]
                out.append((route, r.status, sorted(reply), kept, [rt.epoch for rt, _ in shards]))
        finally:
            if inference.adapter is not None:
                await inference.adapter.shutdown()
            await client.close()
        return out

    async def go():
        shards, servers = [], []
        for name in ("s0", "s1"):
            rt = ShardRuntime(name, device="cpu")
            adapter = RingAdapter(rt, ring_client_factory=FakeRingClient, callback_client_factory=FakeCallbackClient)
            shard = Shard(name, rt, adapter)
            await shard.start()
            srv = TestServer(ShardHTTPServer(shard).app)
            await srv.start_server()
            shards.append((rt, shard))
            servers.append((name, srv))
        try:
            runs = []
            for pkg in ("dnet_tpu", "dnet_tpu_torch"):
                for _, shard in shards:  # each run starts from empty shards
                    await shard.unload_model()
                runs.append(await api_run(pkg, shards, servers))
            return runs
        finally:
            for (_, shard), (_, srv) in zip(shards, servers):
                await srv.close()
                await shard.stop()

    ref, port = asyncio.run(go())
    # the epochs differ between the runs (each API mints its own); the rest
    # must not, and each run's delta load bumps the shards' epoch by one
    assert [row[:4] for row in port] == [row[:4] for row in ref]
    assert [row[1] for row in port] == [200] * 4
    (_, _, _, _, loaded), (_, _, _, kept, after) = port[1], port[3]
    assert kept == [True, True]  # no shard loaded its weights again
    assert after == [e + 1 for e in loaded]


def test_ring_adapter_stamps_the_deadline_into_frames():
    from dnet_tpu_torch.api.inference import DeadlineExceededError, classify_result_error
    from dnet_tpu_torch.api.ring import RingApiAdapter
    from dnet_tpu_torch.core.types import DecodingParams

    class Streams:
        def __init__(self):
            self.frames = []

        async def send(self, nonce, frame):
            self.frames.append(frame)

        async def end_stream(self, nonce):
            pass

    async def go():
        api = RingApiAdapter(head_addr="s0:1", callback_url="grpc://api:1", ring_client_factory=lambda a: None)
        api._streams = streams = Streams()
        dl = time.time() + 30.0
        api.set_deadline("r1", dl)
        await api.send_tokens("r1", [1, 2, 3], DecodingParams(temperature=0.0), 0)
        assert streams.frames[-1].deadline == pytest.approx(dl)
        # a reset drops the registration: later frames carry 0 (none)
        await api.reset_cache("r1")
        await api.send_tokens("r1", [1, 2, 3], DecodingParams(temperature=0.0), 0)
        assert streams.frames[-1].deadline == 0.0

    asyncio.run(go())
    # a shard's drop of an expired frame comes back as a 504, not a 500
    assert isinstance(classify_result_error("deadline exceeded at shard dequeue"), DeadlineExceededError)
