"""The port's HTTP server against dnet_tpu's under DNET_API_PREFIX_CACHE,
DNET_API_SPEC_LOOKAHEAD and DNET_API_DRAFT_MODEL, on the same tiny
checkpoint: greedy responses, streamed and aggregated, byte-identical but
for the response id and the created stamp, on one slot and on dense
batched slots (tests/test_torch_serving.py's pattern).  The prefix cache
serves a two-turn chat whose second turn resends the first (a hit on both
servers); the speculating servers answer a repetitive prompt, so that
drafts land.  The reference's settings reach its manager as its CLI
passes them; the port's manager reads its environment."""

import asyncio
import json

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache
from tests.test_torch_serving import _normalize

pytestmark = [pytest.mark.api, pytest.mark.http]

MAX_SEQ = 256
SPEC_CHAT = {"model": "tiny", "messages": [{"role": "user", "content": "abcabcabcabc"}], "max_tokens": 24,
             "temperature": 0}


def _turns():
    """Turn 1, then turn 2 with turn 1's exchange resent (the answer is
    fixed text: both servers get the same history)."""
    first = [{"role": "user", "content": "Tell me about the sea, please."}]
    second = first + [{"role": "assistant", "content": "The sea is wide."},
                      {"role": "user", "content": "And the sky?"}]
    return [dict(SPEC_CHAT, messages=m, max_tokens=12) for m in (first, second)]


def _managers(settings: dict, slots: int):
    """(reference manager, port manager) for the settings, as the CLIs build
    them."""
    from dnet_tpu.api.inference import InferenceManager as RefInference
    from dnet_tpu.api.model_manager import LocalModelManager as RefManager
    from dnet_tpu_torch.api.inference import InferenceManager
    from dnet_tpu_torch.api.model_manager import LocalModelManager

    ref = RefManager(RefInference(adapter=None, request_timeout_s=120.0, max_concurrent=2), max_seq=MAX_SEQ,
                     param_dtype="float32", batch_slots=slots,
                     prefix_cache=int(settings.get("DNET_API_PREFIX_CACHE", 0)),
                     spec_lookahead=int(settings.get("DNET_API_SPEC_LOOKAHEAD", 0)))
    port = LocalModelManager(InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=2),
                             max_seq=MAX_SEQ, param_dtype="float32", device="cpu", batch_slots=slots)
    return ref, port


async def _serve(app, model_dir, requests):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        assert r.status == 200, await r.text()
        out = []
        for body in requests:
            resp = await client.post("/v1/chat/completions", json=body)
            out.append((resp.status, (await resp.read()).decode()))
        return out
    finally:
        await client.close()


def _both(model_dir, settings: dict, slots: int, requests, monkeypatch):
    from dnet_tpu.api.http import ApiHTTPServer as RefHTTP
    from dnet_tpu_torch.api.http import ApiHTTPServer

    monkeypatch.setenv("DNET_API_WARM_ON_LOAD", "0")
    for name, value in settings.items():
        monkeypatch.setenv(name, value)
    reset_settings_cache()
    try:
        ref_mgr, port_mgr = _managers(settings, slots)
        ref = asyncio.run(_serve(RefHTTP(ref_mgr.inference, ref_mgr).app, model_dir, requests))
        port = asyncio.run(_serve(ApiHTTPServer(port_mgr.inference, port_mgr).app, model_dir, requests))
    finally:
        monkeypatch.undo()
        reset_settings_cache()
    assert [s for s, _ in port] == [s for s, _ in ref] == [200] * len(requests)
    for (_, rb), (_, pb) in zip(ref, port):
        assert _normalize(pb) == _normalize(rb)
    return ref_mgr, port_mgr, port


@pytest.mark.parametrize("slots", [1, 4])
def test_speculation_serves_identical_streams(tiny_llama_dir, monkeypatch, slots):
    """DNET_API_SPEC_LOOKAHEAD=4: the streamed and the aggregated greedy
    answer equal the reference's, and the port's engine ran verify
    blocks."""
    requests = [dict(SPEC_CHAT, stream=True), SPEC_CHAT]
    _, port_mgr, port = _both(tiny_llama_dir, {"DNET_API_SPEC_LOOKAHEAD": "4"}, slots, requests, monkeypatch)
    assert port_mgr.engine.stats()["spec_blocks"] > 0
    events = [ln for ln in port[0][1].splitlines() if ln.startswith("data: ")]
    streamed = "".join(c["delta"].get("content", "") for ev in events[:-1]
                       for c in json.loads(ev[len("data: "):])["choices"])
    assert json.loads(port[1][1])["choices"][0]["message"]["content"] == streamed


def test_draft_model_serves_identical_streams(tiny_llama_dir, monkeypatch):
    """DNET_API_DRAFT_MODEL naming the served checkpoint (a self-draft) with
    DNET_API_SPEC_LOOKAHEAD=4: identical greedy answers, every block's
    drafts accepted but for the request's end."""
    settings = {"DNET_API_SPEC_LOOKAHEAD": "4", "DNET_API_DRAFT_MODEL": str(tiny_llama_dir)}
    requests = [dict(SPEC_CHAT, stream=True), SPEC_CHAT]
    ref_mgr, port_mgr, _ = _both(tiny_llama_dir, settings, 1, requests, monkeypatch)
    assert ref_mgr.engine.draft is not None and port_mgr.engine.draft is not None
    stats = port_mgr.engine.stats()
    assert stats["spec_blocks"] > 0 and stats["spec_emitted"] >= 4 * stats["spec_blocks"]


@pytest.mark.parametrize("slots", [1, 4])
def test_prefix_cache_serves_identical_turns(tiny_llama_dir, monkeypatch, slots):
    """DNET_API_PREFIX_CACHE=4: turn 2 resends turn 1 and hits its snapshot
    on both servers; both turns' answers, streamed, equal the
    reference's."""
    requests = [dict(t, stream=True) for t in _turns()]
    ref_mgr, port_mgr, _ = _both(tiny_llama_dir, {"DNET_API_PREFIX_CACHE": "4"}, slots, requests, monkeypatch)
    got = port_mgr.engine.stats()["prefix_cache"]
    ref_cache = (ref_mgr.engine if slots == 1 else ref_mgr.engine.eng).prefix_cache
    assert got["hits"] == ref_cache.stats["hits"] >= 1
    assert got["stores"] == ref_cache.stats["stores"] >= 2
