"""The port's HTTP server with a quantized KV cache (DNET_KV_BITS) against
dnet_tpu's, serving the same tiny checkpoint on loopback: greedy SSE must
be byte-identical once the response id and created stamp are normalised
(the pattern of tests/subsystems/test_ragged_parity.py), single sequence
and with dense batched slots (--batch-slots, DNET_KV_PAGED unset, the
reference's default batched mode), and over a paged pool, which a
quantized cache decodes through the dense gather (the reference's fallback
from the ragged kernel)."""

import asyncio
import json
import re

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

PROMPTS = ["Hi", "Hello there, friend", "A quick brown fox jumps over it"]


@pytest.fixture
def env(monkeypatch):
    def set_env(**values):
        for k, v in values.items():
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        reset_settings_cache()

    set_env(DNET_KV_PAGED=None, DNET_KV_RAGGED=None, DNET_FLASH_INTERPRET=None, DNET_API_WARM_ON_LOAD="0")
    yield set_env
    reset_settings_cache()


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


def _app(port: bool, kv_bits: int, slots: int = 1):
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
    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=max(slots, 2))
    manager = LocalModelManager(inference, max_seq=64, param_dtype="float32", batch_slots=slots,
                                kv_bits=kv_bits, **kw)
    return ApiHTTPServer(inference, manager).app


def _chat(prompt: str, max_tokens: int = 10, **extra) -> dict:
    return {"model": "tiny", "messages": [{"role": "user", "content": prompt}],
            "max_tokens": max_tokens, "temperature": 0, "stream": True, **extra}


async def _serve(app, model_dir, bodies, concurrent: bool):
    """Load the model, send the bodies (in order or all at once); returns
    the load status and body, the (status, raw body) per request and
    /health after them."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        if r.status != 200:
            return r.status, await r.json(), None

        async def one(body):
            resp = await client.post("/v1/chat/completions", json=body)
            return resp.status, (await resp.read()).decode()

        if concurrent:
            out = await asyncio.gather(*(one(b) for b in bodies))
        else:
            out = [await one(b) for b in bodies]
        health = await (await client.get("/health")).json()
        return 200, out, health
    finally:
        await client.close()


def _both(model_dir, kv_bits, slots, bodies):
    concurrent = slots > 1
    rs, ref, _ = asyncio.run(_serve(_app(False, kv_bits, slots), model_dir, bodies, concurrent))
    ps, port, health = asyncio.run(_serve(_app(True, kv_bits, slots), model_dir, bodies, concurrent))
    assert rs == ps == 200, (ref, port)
    for (r_status, r_body), (p_status, p_body) in zip(ref, port):
        assert r_status == p_status == 200
        assert _normalize(p_body) == _normalize(r_body)
        if p_body.startswith("data: "):
            events = [ln for ln in p_body.splitlines() if ln.startswith("data: ")]
            assert events[-1] == "data: [DONE]" and len(events) > 2
        else:
            assert json.loads(p_body)["usage"]["completion_tokens"] > 0
    return health


@pytest.mark.parametrize("kv_bits", [8, 4, 16])
def test_single_sequence_sse_byte_identical(tiny_llama_dir, env, kv_bits):
    bodies = [_chat(p) for p in PROMPTS[:2]] + [_chat(PROMPTS[2], stream=False)]
    health = _both(tiny_llama_dir, kv_bits, 1, bodies)
    assert health["engine"]["kv_quant_bits"] == (0 if kv_bits == 16 else kv_bits)
    assert health["engine"]["kv_dtype"] == ("bfloat16" if kv_bits == 16 else "float32")


@pytest.mark.parametrize("kv_bits", [8, 0])
def test_dense_batched_slots_sse_byte_identical(tiny_llama_dir, env, kv_bits):
    """--batch-slots 4 without DNET_KV_PAGED: a concurrent burst over dense
    slots streams what dnet_tpu's dense batched server streams."""
    health = _both(tiny_llama_dir, kv_bits, 4, [_chat(p, max_tokens=8) for p in PROMPTS])
    engine = health["engine"]
    assert engine["kv_mode"] == "dense" and engine["kv_quant_bits"] == kv_bits
    assert engine["slots"] == 4 and engine["active"] == 0 and engine["decode_steps"] > 0


def test_kv_bits_setting_and_a_typo_is_422(tiny_llama_dir, env):
    """The server reads DNET_KV_BITS at start (as dnet_tpu/api/server.py:83
    does); a typo is refused at load with 422."""
    from dnet_tpu_torch.config import kv_settings

    env(DNET_KV_BITS="4")
    assert kv_settings().bits == 4
    status, body, _ = asyncio.run(_serve(_app(True, kv_bits=3), tiny_llama_dir, [], False))
    assert status == 422 and "kv_bits=3" in body["error"]["message"]


def test_paged_pool_with_quantized_cache_is_422(tiny_llama_dir, env):
    """Formerly refused with 422: DNET_KV_BITS=8 over a paged pool with
    DNET_KV_RAGGED=1.  Both servers fall back from the ragged kernel to
    the dense-gather decode and stream the same bytes."""
    env(DNET_KV_PAGED="1", DNET_KV_RAGGED="1", DNET_KV_BLOCK_TOKENS="8")
    health = _both(tiny_llama_dir, 8, 4, [_chat(p, max_tokens=8) for p in PROMPTS])
    engine = health["engine"]
    assert engine["kv_mode"] == "paged" and engine["kv_ragged"] is False and engine["kv_quant_bits"] == 8
    assert engine["active"] == 0 and engine["kv_blocks_used"] == 0 and engine["decode_steps"] > 0
