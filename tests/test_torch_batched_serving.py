"""The port's continuously batched HTTP server against dnet_tpu's.

Both serve the same tiny checkpoint with 4 batch slots over a paged pool of
8-token blocks, decoded through ragged paged attention (the reference's
Pallas kernel in interpret mode, the port's plain version on the CPU).  A
concurrent burst of prompts of different lengths must stream byte-identical
greedy SSE once the response id and created stamp are normalised (the
pattern of tests/subsystems/test_ragged_parity.py).  Capacity errors come
back as 429.  The configurations once refused at load serve as the
reference does: a block size that does not divide max_seq on dense slots,
DNET_KV_PAGED=1 without DNET_KV_RAGGED through the dense gather (dense
batched slots, DNET_KV_PAGED unset, are held in
tests/test_torch_kv_serving.py); a prefix cache and the scheduler serve
the reference's bytes (tests/test_torch_sched_serving.py holds the
scheduler in depth)."""

import asyncio
import json
import os
import re

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

SLOTS = 4
PAGED = {"DNET_KV_PAGED": "1", "DNET_KV_RAGGED": "1", "DNET_KV_BLOCK_TOKENS": "8",
         "DNET_FLASH_INTERPRET": "1", "DNET_API_WARM_ON_LOAD": "0"}
# the chat template adds ~20 tokens: these land mid-block at different blocks
PROMPTS = ["Hi", "Hello there, friend", "A quick brown fox jumps over it"]


@pytest.fixture
def paged_env(monkeypatch):
    def set_env(**extra):
        for k, v in {**PAGED, **extra}.items():
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        reset_settings_cache()

    set_env()
    yield set_env
    reset_settings_cache()


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "chatcmpl-X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


def _app(port: bool, slots: int = SLOTS, max_concurrent: int = SLOTS):
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
    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=max_concurrent)
    manager = LocalModelManager(inference, max_seq=64, param_dtype="float32", batch_slots=slots, **kw)
    return ApiHTTPServer(inference, manager).app


def _chat(prompt: str, max_tokens: int = 8, **extra) -> dict:
    return {"model": "tiny", "messages": [{"role": "user", "content": prompt}],
            "max_tokens": max_tokens, "temperature": 0, "stream": True, **extra}


async def _burst(app, model_dir, bodies):
    """Load the model, send every body at once; returns (status, headers,
    raw body) per request and the /health body after the burst."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        if r.status != 200:
            return r.status, await r.json(), None

        async def one(body):
            resp = await client.post("/v1/chat/completions", json=body)
            return resp.status, dict(resp.headers), (await resp.read()).decode()

        out = await asyncio.gather(*(one(b) for b in bodies))
        health = await (await client.get("/health")).json()
        return 200, out, health
    finally:
        await client.close()


def test_concurrent_burst_sse_byte_identical(tiny_llama_dir, paged_env):
    bodies = [_chat(p) for p in PROMPTS]
    rs, ref, _ = asyncio.run(_burst(_app(port=False), tiny_llama_dir, bodies))
    ps, port, health = asyncio.run(_burst(_app(port=True), tiny_llama_dir, bodies))
    assert rs == ps == 200
    for (r_status, _, r_body), (p_status, p_headers, p_body) in zip(ref, port):
        assert r_status == p_status == 200
        assert p_headers["Content-Type"].startswith("text/event-stream")
        assert _normalize(p_body) == _normalize(r_body)
        events = [ln for ln in p_body.splitlines() if ln.startswith("data: ")]
        assert events[-1] == "data: [DONE]" and len(events) > 2
        assert json.loads(events[-2][6:])["usage"]["completion_tokens"] == 8
    # every request's slot and blocks went back
    engine = health["engine"]
    assert engine["slots"] == SLOTS and engine["active"] == 0
    assert engine["kv_blocks_used"] == 0 and engine["decode_steps"] > 0
    assert health["admission"]["capacity"] == SLOTS


def test_pool_exhaustion_is_429(tiny_llama_dir, paged_env):
    """A pool of 4 blocks (32 tokens) cannot take a ~45-token prompt: the
    request is refused with 429 and a Retry-After, and the server keeps
    serving a prompt that fits."""
    paged_env(DNET_KV_POOL_BLOCKS="4")
    status, out, health = asyncio.run(_burst(
        _app(port=True), tiny_llama_dir,
        [_chat("x" * 20, stream=False), _chat("", max_tokens=2, stream=False)],
    ))
    assert status == 200
    (s_big, h_big, b_big), (s_small, _, b_small) = out
    assert s_big == 429 and h_big["Retry-After"] == "1"
    err = json.loads(b_big)["error"]
    assert err["type"] == "rate_limit_exceeded" and err["message"].startswith("paged KV pool exhausted")
    assert s_small == 200, b_small
    assert health["engine"]["kv_blocks_used"] == 0


def test_slot_exhaustion_is_429(tiny_llama_dir, paged_env):
    """Admission wider than the slot pool (the CLI caps it; this test does
    not): the request that finds no free slot gets 429, the others finish."""
    status, out, _ = asyncio.run(_burst(
        _app(port=True, slots=2, max_concurrent=3), tiny_llama_dir,
        [_chat(p, max_tokens=24, stream=False) for p in PROMPTS],
    ))
    assert status == 200
    codes = sorted(s for s, _, _ in out)
    assert codes == [200, 200, 429], [b for _, _, b in out]
    body = next(b for s, _, b in out if s == 429)
    assert "no free batch slots" in json.loads(body)["error"]["message"]


@pytest.mark.parametrize(
    "env,match",
    [
        ({"DNET_KV_BLOCK_TOKENS": "24"}, "divide max_seq"),  # a block size max_seq is no multiple of
        ({"DNET_KV_RAGGED": None}, "DNET_KV_RAGGED=1"),  # dense-gather paged decode
    ],
)
def test_refused_configurations_are_422_at_load(tiny_llama_dir, paged_env, env, match):
    """The two configurations the port refused at load (the refusal's text
    in `match`) now serve the reference's bytes: a block size max_seq is no
    multiple of on dense slots (the reference's "paged KV disabled"
    fallback), and the dense-gather paged decode."""
    paged_env(**env)
    bodies = [_chat(p) for p in PROMPTS]
    rs, ref, _ = asyncio.run(_burst(_app(port=False), tiny_llama_dir, bodies))
    ps, port, health = asyncio.run(_burst(_app(port=True), tiny_llama_dir, bodies))
    assert rs == ps == 200, port
    for (r_status, _, r_body), (p_status, _, p_body) in zip(ref, port):
        assert r_status == p_status == 200
        assert _normalize(p_body) == _normalize(r_body)
    engine = health["engine"]
    assert engine["kv_mode"] == {"divide max_seq": "dense", "DNET_KV_RAGGED=1": "paged"}[match]
    assert engine["kv_ragged"] is False and engine["active"] == 0
    assert engine.get("kv_blocks_used", 0) == 0


@pytest.mark.parametrize(
    "env,engine_key",
    [
        ({"DNET_API_PREFIX_CACHE": "4"}, "prefix_cache"),  # the paged prefix cache
        ({"DNET_SCHED": "1"}, "slots"),  # the iteration-level scheduler
    ],
)
def test_prefix_cache_and_scheduler_serve(tiny_llama_dir, paged_env, env, engine_key):
    """The two configurations served since the scheduler and the paged
    prefix cache were ported: the burst streams the reference's bytes."""
    paged_env(**env)
    bodies = [_chat(p) for p in PROMPTS]
    rs, ref, _ = asyncio.run(_burst(_app(port=False), tiny_llama_dir, bodies))
    ps, port, health = asyncio.run(_burst(_app(port=True), tiny_llama_dir, bodies))
    assert rs == ps == 200
    for (r_status, _, r_body), (p_status, _, p_body) in zip(ref, port):
        assert r_status == p_status == 200
        assert _normalize(p_body) == _normalize(r_body)
    assert engine_key in health["engine"]


def test_single_slot_keeps_the_local_adapter(tiny_llama_dir, paged_env):
    """batch_slots == 1 serves the single-sequence engine as before, even
    with the paged switches on."""
    from dnet_tpu_torch.api.inference import InferenceManager
    from dnet_tpu_torch.api.model_manager import LocalModelManager
    from dnet_tpu_torch.api.strategies import LocalAdapter
    from dnet_tpu_torch.core.engine import LocalEngine

    async def load():
        inference = InferenceManager(adapter=None)
        manager = LocalModelManager(inference, max_seq=64, param_dtype="float32", device="cpu")
        await manager.load_model(str(tiny_llama_dir))
        try:
            return type(manager.engine), type(inference.adapter)
        finally:
            await inference.adapter.shutdown()

    assert asyncio.run(load()) == (LocalEngine, LocalAdapter)
    assert os.environ["DNET_KV_PAGED"] == "1"
