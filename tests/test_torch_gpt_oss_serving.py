"""The port's HTTP server serving gpt_oss against dnet_tpu's, on the tiny
checkpoint (tests/fakes/checkpoints.py make_tiny_gpt_oss, a ring of W = 8):
greedy chat and completions, streamed and aggregated, must be
byte-identical except for the response id and the created stamp, with
prompts and outputs long enough to wrap the ring in both prefill and
decode, single sequence and on batched slots (dense, and with a paged pool
requested, which both servers serve on dense slots).  A ring shard's load
is refused with 422."""

import asyncio
import json
import re

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

MAX_SEQ = 128
CHAT = {
    "model": "tiny",
    "messages": [{"role": "user", "content": "Tell me about the sliding window"}],
    "max_tokens": 24,
    "temperature": 0,
}


@pytest.fixture(scope="module")
def gpt_oss_dir(tmp_path_factory):
    from tests.fakes.checkpoints import make_tiny_gpt_oss

    d = tmp_path_factory.mktemp("tiny_gpt_oss_serving")
    make_tiny_gpt_oss(d)
    return d


@pytest.fixture
def no_warmup(monkeypatch):
    # the reference would otherwise compile every decode-chunk width at load
    monkeypatch.setenv("DNET_API_WARM_ON_LOAD", "0")
    reset_settings_cache()
    yield
    reset_settings_cache()


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


def _app(port: bool, batch_slots: int = 1):
    if port:
        from dnet_tpu_torch.api.http import ApiHTTPServer
        from dnet_tpu_torch.api.inference import InferenceManager
        from dnet_tpu_torch.api.model_manager import LocalModelManager

        kw = {"device": "cpu"}
    else:
        from dnet_tpu.api.http import ApiHTTPServer
        from dnet_tpu.api.inference import InferenceManager
        from dnet_tpu.api.model_manager import LocalModelManager

        kw = {}
    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=2)
    manager = LocalModelManager(inference, max_seq=MAX_SEQ, param_dtype="float32", batch_slots=batch_slots, **kw)
    return ApiHTTPServer(inference, manager).app


async def _serve(app, model_dir, requests):
    """Load the model, then send each (path, body); returns the load's
    (status, body) and (status, raw body) per request."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        if r.status != 200:
            return (r.status, await r.json()), []
        out = []
        for path, body in requests:
            resp = await client.post(path, json=body)
            out.append((resp.status, (await resp.read()).decode()))
        return (200, None), out
    finally:
        await client.close()


def test_sse_and_aggregate_byte_identical(gpt_oss_dir, no_warmup):
    long_prompt = dict(CHAT, messages=[{"role": "user", "content": "A longer question " * 4}])
    requests = [
        ("/v1/chat/completions", dict(CHAT, stream=True)),
        ("/v1/chat/completions", CHAT),
        ("/v1/chat/completions", dict(long_prompt, stream=True)),
        ("/v1/completions", {"model": "tiny", "prompt": "abcdefghijkl", "max_tokens": 16, "temperature": 0}),
    ]
    (rs, _), ref = asyncio.run(_serve(_app(port=False), gpt_oss_dir, requests))
    (ps, _), port = asyncio.run(_serve(_app(port=True), gpt_oss_dir, requests))
    assert rs == ps == 200
    for (r_status, r_body), (p_status, p_body) in zip(ref, port):
        assert r_status == p_status == 200
        assert _normalize(p_body) == _normalize(r_body)
    events = [ln for ln in port[0][1].splitlines() if ln.startswith("data: ")]
    assert events[-1] == "data: [DONE]" and json.loads(events[-2][6:])["usage"]["completion_tokens"] == 24


@pytest.mark.parametrize("env,match", [
    ({"DNET_KV_PAGED": "1", "DNET_KV_RAGGED": "1", "DNET_KV_BLOCK_TOKENS": "8"}, "no paged-attend hook"),
    ({}, "dense batched slots are not ported"),
])
def test_batched_slots_are_422_at_load(gpt_oss_dir, no_warmup, monkeypatch, env, match):
    """--batch-slots 4, which the port refused at load (the refusal's text
    in `match`), now serves the reference's bytes: dense slots, and with
    DNET_KV_PAGED=1 DNET_KV_RAGGED=1 dense slots again (the W-row rings cannot be addressed by blocks)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    reset_settings_cache()
    requests = [
        ("/v1/chat/completions", dict(CHAT, stream=True)),
        ("/v1/chat/completions", dict(CHAT, messages=[{"role": "user", "content": "A longer question " * 4}])),
    ]
    (rs, _), ref = asyncio.run(_serve(_app(port=False, batch_slots=4), gpt_oss_dir, requests))
    (ps, _), port = asyncio.run(_serve(_app(port=True, batch_slots=4), gpt_oss_dir, requests))
    assert rs == ps == 200
    for (r_status, r_body), (p_status, p_body) in zip(ref, port):
        assert r_status == p_status == 200
        assert _normalize(p_body) == _normalize(r_body)
    assert json.loads(port[1][1])["usage"]["completion_tokens"] == 24


def test_ring_shard_load_is_422(gpt_oss_dir):
    """A shard refuses a gpt_oss checkpoint before reading a weight, and a
    shard with nothing loaded stays empty."""
    from dnet_tpu_torch.shard.http import ShardHTTPServer
    from dnet_tpu_torch.shard.runtime import ShardRuntime
    from dnet_tpu_torch.shard.server import Shard

    runtime = ShardRuntime("s0", device="cpu")
    app = ShardHTTPServer(Shard("s0", runtime, adapter=None)).app

    async def load():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/load_model", json={"model_path": str(gpt_oss_dir), "layers": [0, 1]})
            return r.status, await r.json()
        finally:
            await client.close()

    status, body = asyncio.run(load())
    assert status == 422 and "gpt_oss" in body["message"]
    assert runtime.compute is None
