"""The port's HTTP server against dnet_tpu's, serving the same tiny
checkpoint on loopback: greedy responses must be byte-identical except for
the response id and the created stamp (the pattern of
tests/subsystems/test_ragged_parity.py)."""

import asyncio
import json
import re

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

CHAT = {
    "model": "tiny",
    "messages": [{"role": "user", "content": "Hello there"}],
    "max_tokens": 12,
    "temperature": 0,
}


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


def _reference_app():
    from dnet_tpu.api.http import ApiHTTPServer
    from dnet_tpu.api.inference import InferenceManager
    from dnet_tpu.api.model_manager import LocalModelManager

    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=2)
    manager = LocalModelManager(inference, max_seq=64, param_dtype="float32")
    return ApiHTTPServer(inference, manager).app


def _port_app():
    from dnet_tpu_torch.api.http import ApiHTTPServer
    from dnet_tpu_torch.api.inference import InferenceManager
    from dnet_tpu_torch.api.model_manager import LocalModelManager

    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=2)
    manager = LocalModelManager(inference, max_seq=64, param_dtype="float32", device="cpu")
    return ApiHTTPServer(inference, manager).app


async def _serve(app, model_dir, requests):
    """Load the model, then send each (path, body); returns
    (status, content type, raw body) per request."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        assert r.status == 200, await r.text()
        out = []
        for path, body in requests:
            resp = await client.post(path, json=body)
            out.append((resp.status, resp.headers["Content-Type"], (await resp.read()).decode()))
        return out
    finally:
        await client.close()


def _both(model_dir, requests):
    ref = asyncio.run(_serve(_reference_app(), model_dir, requests))
    port = asyncio.run(_serve(_port_app(), model_dir, requests))
    return ref, port


def test_chat_sse_and_aggregate_byte_identical(tiny_llama_dir, no_warmup):
    requests = [
        ("/v1/chat/completions", dict(CHAT, stream=True)),
        ("/v1/chat/completions", CHAT),
        ("/v1/chat/completions", dict(CHAT, stream=True, stop=["\x00"], logprobs=True, top_logprobs=3)),
    ]
    ref, port = _both(tiny_llama_dir, requests)
    for (rs, rt, rb), (ps, pt, pb) in zip(ref, port):
        assert ps == rs == 200
        assert pt.split(";")[0] == rt.split(";")[0]
    sse_ref, sse_port = ref[0][2], port[0][2]
    assert _normalize(sse_port) == _normalize(sse_ref)
    events = [ln for ln in sse_port.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "data: [DONE]" and len(events) > 2
    assert _normalize(port[1][2]) == _normalize(ref[1][2])
    # streamed and aggregated content agree
    streamed = "".join(
        c["delta"].get("content", "")
        for ev in events[:-1]
        for c in json.loads(ev[len("data: "):])["choices"]
    )
    assert json.loads(port[1][2])["choices"][0]["message"]["content"] == streamed
    # logprobs stream: same events, logprob values within f32 parity
    ref_lp = [json.loads(ln[6:]) for ln in ref[2][2].splitlines() if ln.startswith("data: {")]
    port_lp = [json.loads(ln[6:]) for ln in port[2][2].splitlines() if ln.startswith("data: {")]
    assert len(port_lp) == len(ref_lp)
    for a, b in zip(port_lp, ref_lp):
        for ca, cb in zip(a["choices"], b["choices"]):
            assert ca["delta"] == cb["delta"]
            for ea, eb in zip((ca.get("logprobs") or {}).get("content", []),
                              (cb.get("logprobs") or {}).get("content", [])):
                assert ea["token"] == eb["token"]
                assert ea["logprob"] == pytest.approx(eb["logprob"], abs=2e-3)


def test_completions_byte_identical(tiny_llama_dir, no_warmup):
    body = {"model": "tiny", "prompt": "abc", "max_tokens": 6, "temperature": 0, "echo": True}
    ref, port = _both(
        tiny_llama_dir,
        [("/v1/completions", body), ("/v1/completions", dict(body, stream=True))],
    )
    for (rs, _, rb), (ps, _, pb) in zip(ref, port):
        assert ps == rs == 200
        assert _normalize(pb) == _normalize(rb)


def test_errors_keep_their_status(tiny_llama_dir, no_warmup):
    too_long = dict(CHAT, messages=[{"role": "user", "content": "x" * 100}])
    ref, port = _both(
        tiny_llama_dir,
        [("/v1/chat/completions", too_long), ("/v1/chat/completions", {"model": "tiny"})],
    )
    assert [s for s, _, _ in port] == [s for s, _, _ in ref] == [400, 400]
