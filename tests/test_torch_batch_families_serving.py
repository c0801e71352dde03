"""The port's HTTP server against dnet_tpu's in every batched configuration
the port once refused at load: a concurrent greedy burst must stream
byte-identical SSE once the response id and created stamp are normalised.

- gpt_oss on dense batched slots (tests/fakes/checkpoints.py
  make_tiny_gpt_oss: every lane's W = 8 ring wraps at its own position),
  also with DNET_KV_PAGED=1, which both servers serve on dense slots;
- deepseek_v2 on dense slots and through the dense-gather paged decode,
  plain and int8 / int4;
- llama through the dense gather: DNET_KV_PAGED=1 alone, and an int4 pool
  with DNET_KV_RAGGED=1 (the reference's fallback from the ragged kernel);
- the iteration-level scheduler (DNET_SCHED=1) over the dense gather and
  over gpt_oss's dense slots;
- one slot with DNET_KV_PAGED=1: the single-sequence paged ledger, whose
  exhaustion answers 429 before any compute, as the reference's does.

A prefix cache on dense slots, once a 422, serves, also when a paged pool
falls back to them (gpt_oss with DNET_KV_PAGED=1 and
DNET_API_PREFIX_CACHE): the inner engine's snapshot cache.
"""

import asyncio
import json
import re

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

PROMPTS = ["Hi", "Hello there, friend", "A quick brown fox jumps over it"]
BASE = {"DNET_KV_PAGED": None, "DNET_KV_RAGGED": None, "DNET_KV_BLOCK_TOKENS": "8", "DNET_SCHED": None,
        "DNET_FLASH_INTERPRET": None, "DNET_API_WARM_ON_LOAD": "0", "DNET_KV_POOL_BLOCKS": None,
        "DNET_API_PREFIX_CACHE": None}
PAGED = {"DNET_KV_PAGED": "1"}
# id -> (family, env, kv_bits, the /health engine's kv_mode)
CASES = {
    "gpt_oss-dense": ("gpt_oss", {}, 0, "dense"),
    "gpt_oss-paged-falls-back-to-dense": ("gpt_oss", PAGED, 0, "dense"),
    "deepseek_v2-dense": ("deepseek_v2", {}, 0, "dense"),
    "deepseek_v2-gather": ("deepseek_v2", PAGED, 0, "paged"),
    "deepseek_v2-gather-q8": ("deepseek_v2", PAGED, 8, "paged"),
    "deepseek_v2-gather-q4": ("deepseek_v2", PAGED, 4, "paged"),
    "llama-gather": ("llama", PAGED, 0, "paged"),
    "llama-q4-ragged-falls-back-to-gather": ("llama", {**PAGED, "DNET_KV_RAGGED": "1"}, 4, "paged"),
    "llama-sched-gather": ("llama", {**PAGED, "DNET_SCHED": "1"}, 0, "paged"),
    "gpt_oss-sched-dense": ("gpt_oss", {"DNET_SCHED": "1"}, 0, "dense"),
}


@pytest.fixture
def env(monkeypatch):
    def set_env(**values):
        for k, v in values.items():
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        reset_settings_cache()

    set_env(**BASE)
    yield set_env
    reset_settings_cache()


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory, tiny_llama_dir):
    from tests.fakes.checkpoints import make_tiny_deepseek_v2, make_tiny_gpt_oss

    out = {"llama": tiny_llama_dir, "gpt_oss": tmp_path_factory.mktemp("oss"),
           "deepseek_v2": tmp_path_factory.mktemp("ds")}
    make_tiny_gpt_oss(out["gpt_oss"])
    make_tiny_deepseek_v2(out["deepseek_v2"])
    return out


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


def _app(port: bool, slots: int, kv_bits: int = 0, max_seq: int = 128):
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
    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=max(slots, 3))
    manager = LocalModelManager(inference, max_seq=max_seq, param_dtype="float32", batch_slots=slots,
                                kv_bits=kv_bits, **kw)
    return ApiHTTPServer(inference, manager).app


def _chat(prompt: str, max_tokens: int = 12, **extra) -> dict:
    # the tiny random models would otherwise end some streams on EOS at once
    return {"model": "tiny", "messages": [{"role": "user", "content": prompt}], "max_tokens": max_tokens,
            "temperature": 0, "stream": True, "logit_bias": {"257": -100.0}, **extra}


async def _serve(app, model_dir, bodies, concurrent=True):
    """Load the model, send the bodies (all at once, or in order); returns
    the load's (status, body), (status, raw body) per request and /health."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        if r.status != 200:
            return (r.status, await r.json()), [], None

        async def one(body):
            resp = await client.post("/v1/chat/completions", json=body)
            return resp.status, (await resp.read()).decode()

        if concurrent:
            out = await asyncio.gather(*(one(b) for b in bodies))
        else:
            out = [await one(b) for b in bodies]
        health = await (await client.get("/health")).json()
        return (200, None), out, health
    finally:
        await client.close()


def _both(model_dir, bodies, slots, kv_bits=0, concurrent=True, max_seq=128):
    (rs, _), ref, _ = asyncio.run(_serve(_app(False, slots, kv_bits, max_seq), model_dir, bodies, concurrent))
    (ps, err), port, health = asyncio.run(_serve(_app(True, slots, kv_bits, max_seq), model_dir, bodies, concurrent))
    assert rs == ps == 200, err
    assert [s for s, _ in port] == [s for s, _ in ref], port
    for (_, r_body), (_, p_body) in zip(ref, port):
        assert _normalize(p_body) == _normalize(r_body)
    return port, health


@pytest.mark.parametrize("case", list(CASES))
def test_burst_sse_byte_identical(model_dirs, env, case):
    family, case_env, kv_bits, mode = CASES[case]
    env(**case_env)
    port, health = _both(model_dirs[family], [_chat(p) for p in PROMPTS], slots=4, kv_bits=kv_bits)
    for status, body in port:
        assert status == 200
        events = [ln for ln in body.splitlines() if ln.startswith("data: ")]
        assert events[-1] == "data: [DONE]" and json.loads(events[-2][6:])["usage"]["completion_tokens"] == 12
    engine = health["engine"]
    assert engine["kv_mode"] == mode and engine["kv_ragged"] is False and engine["kv_quant_bits"] == kv_bits
    assert engine["active"] == 0 and engine.get("kv_blocks_used", 0) == 0 and engine["decode_steps"] > 0


def test_gpt_oss_paged_fallback_with_a_prefix_cache_is_422(model_dirs, env):
    """The paged pool falls back to dense slots, where the reference serves
    its dense snapshot prefix cache: once a 422 at load, this now serves
    the reference's bytes (the cache changes no output), the snapshots in
    the inner engine's cache."""
    env(**PAGED, DNET_API_PREFIX_CACHE="4")
    port, health = _both(model_dirs["gpt_oss"], [_chat(p) for p in PROMPTS], slots=4)
    assert all(status == 200 for status, _ in port)
    engine = health["engine"]
    assert engine["kv_mode"] == "dense" and engine["prefix_cache"]["stores"] >= 1


def test_single_slot_paged_ledger_serves_and_answers_429(model_dirs, env):
    """--batch-slots 1 with DNET_KV_PAGED=1: the same bytes as the
    reference's LocalEngine with its ledger, in order; then a pool of 4
    blocks (32 tokens) refuses a ~45-token prompt with 429 before any
    compute, serves a prompt that fits, and holds no block afterwards."""
    env(**PAGED)
    bodies = [_chat(p) for p in PROMPTS] + [_chat(PROMPTS[1], stream=False)]
    _, health = _both(model_dirs["llama"], bodies, slots=1, concurrent=False, max_seq=64)
    assert health["engine"]["kv_mode"] == "paged" and health["engine"]["kv_blocks_used"] == 0
    env(DNET_KV_POOL_BLOCKS="4")
    port, health = _both(model_dirs["llama"], [_chat("x" * 20, stream=False), _chat("", max_tokens=2)],
                         slots=1, concurrent=False, max_seq=64)
    (s_big, b_big), (s_small, _) = port
    assert s_big == 429 and s_small == 200
    assert json.loads(b_big)["error"]["message"].startswith("paged KV pool exhausted")
    engine = health["engine"]
    assert engine["kv_pool_blocks"] == 4 and engine["kv_blocks_used"] == 0 and engine["kv_blocks_peak"] > 0
