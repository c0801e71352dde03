"""Sequence-parallel serving of gpt_oss, deepseek_v2 and a quantized KV
cache: the port's HTTP server with a mesh of sp = 2 ranks on the CPU
against dnet_tpu's mesh server (`MeshEngine(pp=1, sp=2)`) on the same tiny
checkpoints.  Greedy chat and completions, streamed and aggregated, must be
byte-identical except for the response id and the created stamp
(tests/test_torch_serving.py's pattern): gpt_oss and deepseek_v2 (the
deepseek_v2 checkpoint from seed 5, as tests/test_torch_sp_families.py)
with plain caches, llama with DNET_KV_BITS=8, and deepseek_v2 with 8 too.
One prompt's KV crosses the shard boundary at 32.  Both servers get
logit_bias -100 on the byte tokenizer's EOS, so the tiny models' streams
run their full length.  /health's engine block reports the mesh engine's
form: sp, its devices, the KV bits and each rank's KV bytes.  The reference
runs with DNET_FLASH_INTERPRET=1, as its own tests run it.
"""

import asyncio
import json
import re

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

MAX_SEQ = 64
CHAT = {
    "model": "tiny",
    "messages": [{"role": "user", "content": "Hi there"}],
    "max_tokens": 12,
    "temperature": 0,
    "logit_bias": {"257": -100.0},
}
# 40 prompt tokens under the byte tokenizer's chat template: the prefill
# crosses the shard boundary at 32 and decode writes rank 1
LONG_CHAT = dict(CHAT, messages=[{"role": "user", "content": "Tell me a story"}])
CASES = [("gpt_oss", 0), ("deepseek_v2", 0), ("deepseek_v2", 8), ("llama", 8)]


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNET_FLASH_INTERPRET", "1")
        mp.setenv("DNET_API_WARM_ON_LOAD", "0")  # the reference would compile every chunk width at load
        reset_settings_cache()
        yield
    reset_settings_cache()


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory, tiny_llama_dir):
    from tests.fakes.checkpoints import make_tiny_deepseek_v2, make_tiny_gpt_oss

    oss = tmp_path_factory.mktemp("tiny_gpt_oss_sp_serving")
    make_tiny_gpt_oss(oss)
    ds = tmp_path_factory.mktemp("tiny_deepseek_sp_serving")
    make_tiny_deepseek_v2(ds, seed=5)
    return {"gpt_oss": oss, "deepseek_v2": ds, "llama": tiny_llama_dir}


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


def _app(port: bool, kv_bits: int):
    if port:
        from dnet_tpu_torch.api.http import ApiHTTPServer
        from dnet_tpu_torch.api.inference import InferenceManager
        from dnet_tpu_torch.api.model_manager import LocalModelManager

        kw = {"device": "cpu", "mesh": {"sp": 2}}
    else:
        from dnet_tpu.api.http import ApiHTTPServer
        from dnet_tpu.api.inference import InferenceManager
        from dnet_tpu.api.model_manager import LocalModelManager

        kw = {"mesh": {"pp": 1, "sp": 2}}
    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=2)
    manager = LocalModelManager(inference, max_seq=MAX_SEQ, param_dtype="float32", kv_bits=kv_bits, **kw)
    return ApiHTTPServer(inference, manager).app, inference


async def _serve(app, inference, model_dir, requests):
    """Load the model, then send each (method, path, body); returns
    (status, raw body) per request, the load first."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        out = [(r.status, await r.text())]
        if r.status == 200:
            for method, path, body in requests:
                resp = await (client.post(path, json=body) if method == "POST" else client.get(path))
                out.append((resp.status, (await resp.read()).decode()))
        return out
    finally:
        await client.close()
        if inference.adapter is not None:
            await inference.adapter.shutdown()


@pytest.mark.parametrize("family,kv_bits", CASES)
def test_sse_and_aggregate_byte_identical(model_dirs, family, kv_bits):
    requests = [
        ("POST", "/v1/chat/completions", dict(CHAT, stream=True)),
        ("POST", "/v1/chat/completions", CHAT),
        ("POST", "/v1/chat/completions", dict(LONG_CHAT, stream=True)),
        ("POST", "/v1/completions", {"model": "tiny", "prompt": "abc", "max_tokens": 6, "temperature": 0,
                                     "echo": True, "stream": True, "logit_bias": {"257": -100.0}}),
    ]
    ref = asyncio.run(_serve(*_app(False, kv_bits), model_dirs[family], requests))
    port = asyncio.run(_serve(*_app(True, kv_bits), model_dirs[family], requests + [("GET", "/health", None)]))
    assert [s for s, _ in ref] == [200] * 5 and [s for s, _ in port] == [200] * 6, (ref[0], port[0])
    for (_, rb), (_, pb) in zip(ref[1:], port[1:5]):
        assert _normalize(pb) == _normalize(rb)
    events = [ln for ln in port[3][1].splitlines() if ln.startswith("data: {")]
    usage = json.loads(events[-1][6:])["usage"]
    assert usage["prompt_tokens"] > 32 and usage["completion_tokens"] == 12  # across the boundary
    engine = json.loads(port[5][1])["engine"]
    assert engine["sp"] == 2 and engine["devices"] == ["cpu", "cpu"] and engine["kv_quant_bits"] == kv_bits
    assert engine["kv_bytes_per_rank"] == [engine["kv_bytes"] // 2] * 2 > [0, 0]
