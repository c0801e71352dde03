"""The port's DNET_SCHED=1 server against dnet_tpu's, over HTTP.

Both serve the same tiny checkpoint through the iteration-level scheduler
(the port's sched/ and kv/prefix.py, the reference's): concurrent greedy
streams must be byte-identical once the response id and created stamp are
normalised, on dense batched slots and on paged + ragged slots of 8-token
blocks (the reference's Pallas kernels in interpret mode, the port's plain
versions on the CPU), under a pool small enough to preempt, and across a
two-turn conversation that hits the paged prefix cache.  The scheduler's
texts also equal the port's legacy batched adapter's, and
GET /v1/debug/sched serves the tick records the checks read."""

import asyncio
import json
import re

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

BASE = {"DNET_SCHED": "1", "DNET_FLASH_INTERPRET": "1", "DNET_API_WARM_ON_LOAD": "0"}
PAGED = {"DNET_KV_PAGED": "1", "DNET_KV_RAGGED": "1", "DNET_KV_BLOCK_TOKENS": "8"}
PROMPTS = ["Hi", "Hello there", "A quick brown fox", "x" * 30, "mid prompt here"]


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


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "chatcmpl-X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


def _app(port: bool, slots: int = 4, max_seq: int = 64):
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
    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=8)
    manager = LocalModelManager(inference, max_seq=max_seq, param_dtype="float32", batch_slots=slots, **kw)
    return ApiHTTPServer(inference, manager).app


def _chat(messages, max_tokens: int = 8, deadline_s=None) -> dict:
    if isinstance(messages, str):
        messages = [{"role": "user", "content": messages}]
    body = {"model": "tiny", "messages": messages, "max_tokens": max_tokens, "temperature": 0, "stream": True}
    if deadline_s is not None:
        body["deadline_s"] = deadline_s
    return body


def _text(raw: str) -> str:
    """The streamed content of one SSE body."""
    out = []
    for line in raw.splitlines():
        if line.startswith("data: {"):
            for choice in json.loads(line[6:]).get("choices", []):
                out.append((choice.get("delta") or {}).get("content") or "")
    return "".join(out)


async def _serve(app, model_dir, rounds):
    """Load the model, then send each round's bodies at once (a round may be
    a function of the earlier rounds' raw bodies); returns (raw bodies per
    round, /health, /v1/debug/sched, the ticks captured before each round)."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        assert r.status == 200, await r.text()

        async def one(body):
            resp = await client.post("/v1/chat/completions", json=body)
            assert resp.status == 200, await resp.text()
            assert resp.headers["Content-Type"].startswith("text/event-stream")
            return (await resp.read()).decode()

        out, marks = [], []
        for bodies in rounds:
            if callable(bodies):
                bodies = bodies(out)
            snap = await (await client.get("/v1/debug/sched")).json()
            marks.append(snap["summary"]["ticks_captured"])
            out.append(await asyncio.gather(*(one(b) for b in bodies)))
        health = await (await client.get("/health")).json()
        debug = await (await client.get("/v1/debug/sched")).json()
        return out, health, debug, marks
    finally:
        await client.close()


def _since(debug: dict, mark: int) -> list:
    """The tick records from capture index `mark` on (the ring is the
    process's: earlier servers' ticks precede)."""
    records = [r for r in debug["records"] if r["seq"] >= mark]
    assert records and records[0]["seq"] == mark  # none fell out of the ring
    return records


def _both(model_dir, rounds, **app_kw):
    ref = asyncio.run(_serve(_app(False, **app_kw), model_dir, rounds))
    port = asyncio.run(_serve(_app(True, **app_kw), model_dir, rounds))
    for r_round, p_round in zip(ref[0], port[0]):
        for r_body, p_body in zip(r_round, p_round):
            assert _normalize(p_body) == _normalize(r_body)
            events = [ln for ln in p_body.splitlines() if ln.startswith("data: ")]
            assert events[-1] == "data: [DONE]" and len(events) > 2
    return ref, port


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mixed_burst_sse_byte_identical(tiny_llama_dir, env, layout):
    """More requests than the 4 slots asked for: the scheduler widens to 8
    (max(batch_slots, 8)), packs their prefills and decode steps into
    ticks, and every stream equals the reference scheduler's."""
    if layout == "paged":
        env(**PAGED)
    _, (_, health, debug, marks) = _both(tiny_llama_dir, [[_chat(p) for p in PROMPTS]])
    engine = health["engine"]
    assert engine["slots"] == 8 and engine["active"] == 0 and engine["kv_mode"] == layout
    assert engine.get("kv_blocks_used", 0) == 0
    ticks = _since(debug, marks[0])
    assert sum(r["prefill_segments"] for r in ticks) == len(PROMPTS)
    assert not any(r["errors"] or r["preempted"] for r in ticks)
    assert sum(r["decode_steps"] for r in ticks) == engine["decode_steps"] > 0
    assert sum(r["decode_lanes"] for r in ticks) >= len(PROMPTS) * 7


def test_small_pool_preempts_and_resumes(tiny_llama_dir, env):
    """A pool that admits both residents but cannot cover their decode
    growth: the lower-priority sequence is preempted (its prefix aliased
    into the cache), resumes by re-prefilling, and both texts equal the
    reference scheduler's."""
    # each chat-templated prompt is 45 tokens (6 blocks of 8): 13 blocks
    # admit both, not their growth to max_seq; the second request's
    # deadline out-ranks the first, which becomes the victim mid-decode
    env(**PAGED, DNET_KV_POOL_BLOCKS="13", DNET_SCHED_SLOTS="2")
    bodies = [_chat("a" * 20, 28), _chat("b" * 20, 28, deadline_s=30.0)]
    _, (_, health, debug, marks) = _both(tiny_llama_dir, [bodies])
    assert sum(r["preempted"] for r in _since(debug, marks[0])) >= 1
    assert health["engine"]["kv_blocks_used"] == 0 and health["engine"]["active"] == 0


def test_two_turn_conversation_hits_the_prefix_cache(tiny_llama_dir, env):
    """Turn 2 resends turn 1's prompt and answer plus a new message: its
    prefill starts from turn 1's stored blocks (fewer prefill tokens than
    its prompt) and its text equals the reference's."""
    env(**PAGED, DNET_API_PREFIX_CACHE="4")
    first = "Tell me a story"

    def turn2(out):
        answer = _text(out[0][0])
        return [_chat([{"role": "user", "content": first}, {"role": "assistant", "content": answer},
                       {"role": "user", "content": "more"}], 6)]

    _, (rounds, health, debug, marks) = _both(tiny_llama_dir, [[_chat(first, 6)], turn2], max_seq=128)
    cache = health["engine"]["prefix_cache"]
    assert cache["hits"] >= 1 and cache["stores"] >= 1
    from dnet_tpu_torch.utils.tokenizer import load_tokenizer

    tok = load_tokenizer(tiny_llama_dir)
    answer = _text(rounds[0][0])
    n_prompt = len(tok.encode(tok.apply_chat_template(
        [{"role": "user", "content": first}, {"role": "assistant", "content": answer},
         {"role": "user", "content": "more"}])))
    assert 0 < sum(r["prefill_tokens"] for r in _since(debug, marks[1])) < n_prompt


def test_scheduler_matches_the_legacy_adapter(tiny_llama_dir, env):
    """The port's scheduler and its legacy batched adapter serve the same
    texts on paged slots (the scheduler's slots widen, the legacy ones do
    not: 8 against 4)."""
    env(**PAGED)
    sched = asyncio.run(_serve(_app(True), tiny_llama_dir, [[_chat(p) for p in PROMPTS[:4]]]))
    env(DNET_SCHED=None)
    legacy = asyncio.run(_serve(_app(True), tiny_llama_dir, [[_chat(p) for p in PROMPTS[:4]]]))
    assert [_normalize(b) for b in sched[0][0]] == [_normalize(b) for b in legacy[0][0]]
    assert sched[1]["engine"]["slots"] == 8 and legacy[1]["engine"]["slots"] == 4


def test_debug_sched_trims_and_validates(tiny_llama_dir, env):
    env(**PAGED)

    async def go():
        client = TestClient(TestServer(_app(True)))
        await client.start_server()
        try:
            r = await client.post("/v1/load_model", json={"model": str(tiny_llama_dir)})
            assert r.status == 200
            resp = await client.post("/v1/chat/completions", json=_chat("Hi", 4))
            await resp.read()
            full = await (await client.get("/v1/debug/sched")).json()
            last2 = await (await client.get("/v1/debug/sched?last=2")).json()
            none = await (await client.get("/v1/debug/sched?last=0")).json()
            bad = await client.get("/v1/debug/sched?last=x")
            return full, last2, none, bad.status
        finally:
            await client.close()

    full, last2, none, bad = asyncio.run(go())
    assert len(full["records"]) >= 2 and last2["records"] == full["records"][-2:]
    assert none["records"] == [] and bad == 400
    assert full["states"] == ["waiting", "prefilling", "decoding"]
    rec = full["records"][-1]
    assert rec["budget_tokens"] == 2048 and rec["kv_pool_blocks"] > 0
