"""Weight-only int8 / int4 quantization on every serving path of the port,
against dnet_tpu's on the same tiny checkpoints.

- Continuous batching (`--batch-slots 4`): a MoE family (qwen3_moe) at bits
  8 over dense slots and over a paged pool decoded by the ragged kernel;
  interleaved greedy streams equal the reference's BatchedEngine's.
- Sequence parallelism: the sp = 2 MeshEngine (both ranks on the CPU) at
  bits 8 against the reference's MeshEngine(pp=1, tp=1, sp=2): prefill
  logits within 2e-3 and equal greedy streams.
- HTTP: a `<id>:int8` model id, and DNET_API_WEIGHT_QUANT_BITS=4, served by
  both packages' servers: greedy SSE byte-identical once the response id
  and created stamp are normalised, and /v1/models (the catalog with its
  quant variants, and the loaded id) equal; and the scheduler
  (DNET_SCHED=1) over paged + ragged slots at `<id>:int8`, a concurrent
  burst byte-identical to the reference's scheduler.
(The ring, two in-process shards at weight_quant_bits 8, is in
tests/test_torch_ring.py `test_weight_quant_load_option_serves`.)

The reference runs its Pallas kernels in interpret mode
(DNET_FLASH_INTERPRET=1) for the engines, as its own tests run them.
"""

import asyncio
import re

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.batch import BatchedEngine
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.ops.quant import is_quantized
from dnet_tpu_torch.parallel.engine import MeshEngine

pytestmark = [pytest.mark.api, pytest.mark.http]

TOL = dict(atol=2e-3, rtol=2e-3)
MAX_SEQ = 64
PROMPTS = {"a": [256, 72, 105], "b": [256] + list(b"The quick brown fox"), "c": [256, 1, 2, 3, 4, 5, 6, 7, 8]}
STEPS = 10
BATCH_MODES = {
    "dense": {"DNET_KV_PAGED": None, "DNET_KV_RAGGED": None},
    "paged-ragged": {"DNET_KV_PAGED": "1", "DNET_KV_RAGGED": "1", "DNET_KV_BLOCK_TOKENS": "8"},
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

    set_env(DNET_KV_PAGED=None, DNET_KV_RAGGED=None, DNET_KV_BLOCK_TOKENS=None, DNET_FLASH_INTERPRET=None,
            DNET_API_WARM_ON_LOAD="0", DNET_API_WEIGHT_QUANT_BITS=None, DNET_SCHED=None)
    yield set_env
    reset_settings_cache()


@pytest.fixture(scope="module")
def qwen3_moe_dir(tmp_path_factory):
    from tests.fakes.checkpoints import make_tiny_qwen3_moe

    d = tmp_path_factory.mktemp("wq_qwen3_moe")
    make_tiny_qwen3_moe(d)
    return d


def _interleaved(eng, dec, steps=STEPS):
    """Every prompt prefilled, then `steps` batched greedy steps with every
    lane at its own position; the tokens per request."""
    got = {}
    for n, ids in PROMPTS.items():
        got[n] = [int(np.asarray(eng.prefill_and_sample(n, ids, dec).token).reshape(-1)[0])]
    for _ in range(1, steps):
        out, errs = eng.decode_batch({n: (got[n][-1], dec) for n in PROMPTS})
        assert not errs, errs
        for n, r in out.items():
            got[n].append(int(np.asarray(r.token).reshape(-1)[0]))
    for n in PROMPTS:
        eng.end_session(n)
    return got


@pytest.mark.parametrize("mode", list(BATCH_MODES))
def test_batched_slots_match_the_reference(qwen3_moe_dir, env, mode):
    from dnet_tpu.core.batch import BatchedEngine as RefBatched

    env(**BATCH_MODES[mode])
    kw = dict(slots=4, max_seq=MAX_SEQ, param_dtype="float32", weight_quant_bits=8)
    ref = RefBatched(qwen3_moe_dir, **kw)
    port = BatchedEngine(qwen3_moe_dir, device="cpu", **kw)
    stats = port.stats()
    assert stats["kv_mode"] == ("paged" if mode != "dense" else "dense")
    assert stats["kv_ragged"] is (mode == "paged-ragged") and stats["weight_quant_bits"] == 8
    assert is_quantized(port.eng.window_params[0]["e_gate"])
    assert _interleaved(port, DecodingParams()) == _interleaved(ref, RefDecoding(temperature=0.0))


def test_sp_mesh_matches_the_reference(tiny_llama_dir, env):
    from dnet_tpu.parallel.engine import MeshEngine as RefMesh

    env(DNET_FLASH_INTERPRET="1")
    ref = RefMesh(tiny_llama_dir, pp=1, tp=1, sp=2, max_seq=MAX_SEQ, param_dtype="float32", weight_quant_bits=8)
    mesh = MeshEngine(tiny_llama_dir, sp=2, max_seq=MAX_SEQ, param_dtype="float32", device="cpu",
                      weight_quant_bits=8)
    stats = mesh.stats()
    assert stats["sp"] == 2 and stats["weight_quant_bits"] == 8
    assert stats["weight_bytes"] == mesh.weight_stats()["weight_bytes"] > 0
    prompt = PROMPTS["b"] * 2  # 41 tokens: the KV crosses the ranks' boundary at 32
    np.testing.assert_allclose(mesh.prefill("p", prompt).numpy(), np.asarray(ref.prefill("p", prompt)), **TOL)
    mesh.end_session("p")
    ref.end_session("p")
    want = [r.token_id for r in ref.generate(prompt, RefDecoding(), max_tokens=12, nonce="g")]
    assert [r.token_id for r in mesh.generate(prompt, DecodingParams(), max_tokens=12, nonce="g")] == want


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


def _app(port: bool, weight_quant_bits: int = 0):
    """Either package's API server; the reference's manager takes the bits
    its CLI reads from DNET_API_WEIGHT_QUANT_BITS, the port's reads the
    variable at load."""
    if port:
        from dnet_tpu_torch.api.http import ApiHTTPServer
        from dnet_tpu_torch.api.inference import InferenceManager
        from dnet_tpu_torch.api.model_manager import LocalModelManager

        kw = {"device": "cpu"}
    else:
        from dnet_tpu.api.http import ApiHTTPServer
        from dnet_tpu.api.inference import InferenceManager
        from dnet_tpu.api.model_manager import LocalModelManager

        kw = {"weight_quant_bits": weight_quant_bits}
    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=2)
    manager = LocalModelManager(inference, max_seq=MAX_SEQ, param_dtype="float32", **kw)
    return ApiHTTPServer(inference, manager).app


def _chat(model: str, prompt: str, **extra) -> dict:
    return {"model": model, "messages": [{"role": "user", "content": prompt}], "max_tokens": 10,
            "temperature": 0, "stream": True, **extra}


async def _serve(app, model: str, bodies: list):
    """Load `model`, send the bodies in order; returns the (status, raw
    body) per request, /v1/models and /health."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": model})
        assert r.status == 200, await r.text()
        out = []
        for body in bodies:
            resp = await client.post("/v1/chat/completions", json=body)
            out.append((resp.status, (await resp.read()).decode()))
        models = await (await client.get("/v1/models")).json()
        health = await (await client.get("/health")).json()
        return out, models, health
    finally:
        await client.close()


@pytest.mark.parametrize("how", ["id-int8", "env-bits-4"])
def test_sse_and_models_equal_the_reference(tiny_llama_dir, env, how):
    """`<id>:int8` loads the base checkpoint at int8 (the int8 default group,
    128); DNET_API_WEIGHT_QUANT_BITS=4 the plain id at int4."""
    if how == "id-int8":
        model, bits = f"{tiny_llama_dir}:int8", 0
    else:
        model, bits = str(tiny_llama_dir), 4
        env(DNET_API_WEIGHT_QUANT_BITS="4")
    bodies = [_chat(model, "Hi"), _chat(model, "A quick brown fox jumps over it"),
              _chat(model, "Hello there", stream=False)]
    ref, ref_models, _ = asyncio.run(_serve(_app(False, bits), model, bodies))
    port, port_models, health = asyncio.run(_serve(_app(True), model, bodies))
    for (r_status, r_body), (p_status, p_body) in zip(ref, port):
        assert r_status == p_status == 200
        assert _normalize(p_body) == _normalize(r_body)
    assert "data: [DONE]" in port[0][1]
    strip = [{k: v for k, v in m.items() if k != "created"} for m in port_models["data"]]
    assert strip == [{k: v for k, v in m.items() if k != "created"} for m in ref_models["data"]]
    ids = [m["id"] for m in port_models["data"]]
    assert "meta-llama/Llama-3.3-70B-Instruct:int8" in ids and ids[-1] == model
    assert health["engine"]["weight_quant_bits"] == (8 if how == "id-int8" else 4)


def test_scheduler_sse_equals_the_reference(tiny_llama_dir, env):
    """DNET_SCHED=1 over paged + ragged slots of 8-token blocks: the
    scheduler's batched engine loads `<id>:int8` (4 slots widened to 8) and
    a concurrent burst streams what the reference's scheduler streams."""
    env(DNET_SCHED="1", DNET_FLASH_INTERPRET="1", **BATCH_MODES["paged-ragged"])
    model = f"{tiny_llama_dir}:int8"
    bodies = [_chat(model, p, max_tokens=8) for p in ("Hi", "Hello there", "A quick brown fox", "x" * 30)]

    async def burst(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/v1/load_model", json={"model": model})
            assert r.status == 200, await r.text()

            async def one(body):
                resp = await client.post("/v1/chat/completions", json=body)
                return resp.status, (await resp.read()).decode()

            out = await asyncio.gather(*(one(b) for b in bodies))
            return out, await (await client.get("/health")).json()
        finally:
            await client.close()

    def app(port: bool):
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
        return ApiHTTPServer(inference, LocalModelManager(inference, max_seq=MAX_SEQ, param_dtype="float32",
                                                          batch_slots=4, **kw)).app

    ref, _ = asyncio.run(burst(app(False)))
    port, health = asyncio.run(burst(app(True)))
    assert [s for s, _ in port] == [s for s, _ in ref] == [200] * len(bodies)
    assert [_normalize(b) for _, b in port] == [_normalize(b) for _, b in ref]
    engine = health["engine"]
    assert engine["weight_quant_bits"] == 8 and engine["kv_mode"] == "paged" and engine["slots"] == 8
