"""/v1/embeddings and /v1/unload_model: the port's server against dnet_tpu's.

Both serve mean-pooled final hidden states (one prefill forward over a
throwaway session: on the CPU the port's prefill runs its kernel's plain
version) for the same inputs, a string, a batch of strings and token ids,
in f32 and base64, on the tiny llama, on a tiny qwen3_moe, at `:int8`
weights, on dense batched slots and over sp = 2 ranks; a streamed weight plan
(`window_size`) is held engine to engine.  They agree within 2e-3, the
logits' tolerance (tests/test_llama_parity.py:40); the largest error seen
stands in each assertion's message.  The ring answers 501 on both, and
after /v1/unload_model both answer /health alike.
"""

import asyncio
import base64
import importlib

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

PACKAGES = ("dnet_tpu", "dnet_tpu_torch")
TOL = 2e-3
INPUTS = [
    {"input": "Hello there, tiny model"},
    {"input": ["a", "A quick brown fox jumps over the lazy dog"]},
    {"input": [[256, 72, 105, 33, 7, 81, 99, 12, 40]], "encoding_format": "base64"},
]


@pytest.fixture(scope="module")
def dirs(tiny_llama_dir, tmp_path_factory):
    from tests.fakes.checkpoints import make_tiny_qwen3_moe

    moe = tmp_path_factory.mktemp("qwen3_moe")
    make_tiny_qwen3_moe(moe)
    return {"llama": str(tiny_llama_dir), "qwen3_moe": str(moe), "llama:int8": f"{tiny_llama_dir}:int8"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DNET_API_WARM_ON_LOAD", "0")
    monkeypatch.setenv("DNET_FLASH_INTERPRET", "1")
    for k in ("DNET_KV_PAGED", "DNET_SCHED", "DNET_API_WEIGHT_QUANT_BITS", "DNET_REQUEST_DEADLINE_S"):
        monkeypatch.delenv(k, raising=False)
    reset_settings_cache()
    yield
    reset_settings_cache()


def _stack(pkg, slots=1, sp=False):
    http = importlib.import_module(f"{pkg}.api.http")
    inference_mod = importlib.import_module(f"{pkg}.api.inference")
    manager_mod = importlib.import_module(f"{pkg}.api.model_manager")
    inference = inference_mod.InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=4)
    kw = {"device": "cpu"} if pkg == "dnet_tpu_torch" else {}
    if sp:
        kw["mesh"] = {"sp": 2} if pkg == "dnet_tpu_torch" else {"pp": 1, "sp": 2}
    manager = manager_mod.LocalModelManager(inference, max_seq=64, param_dtype="float32", batch_slots=slots, **kw)
    return http.ApiHTTPServer(inference, manager), inference


def _vectors(body: dict, fmt: str) -> list:
    out = []
    for row in body["data"]:
        v = row["embedding"]
        out.append(np.frombuffer(base64.b64decode(v), dtype=np.float32) if fmt == "base64" else np.asarray(v))
    return out


async def _embed_all(pkg, model, slots=1, unload=False, sp=False):
    server, _inference = _stack(pkg, slots, sp)
    client = TestClient(TestServer(server.app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": model})
        assert r.status == 200, await r.text()
        out = []
        for body in INPUTS:
            resp = await client.post("/v1/embeddings", json=dict(body, model="tiny"))
            assert resp.status == 200, await resp.text()
            got = await resp.json()
            out.append((got["usage"], _vectors(got, body.get("encoding_format", "float"))))
        health = None
        if unload:
            r = await client.post("/v1/unload_model")
            assert r.status == 200 and (await r.json()) == {"status": "ok", "message": "unloaded"}
            health = await (await client.get("/health")).json()
            r = await client.post("/v1/embeddings", json=dict(INPUTS[0], model="tiny"))
            health["after"] = (r.status, await r.json())
        return out, health
    finally:
        await client.close()


def _assert_close(ref, port):
    err = 0.0
    for (ref_usage, ref_vecs), (usage, vecs) in zip(ref, port):
        assert usage == ref_usage
        assert len(vecs) == len(ref_vecs)
        for a, b in zip(vecs, ref_vecs):
            assert a.shape == b.shape and np.isfinite(a).all()
            err = max(err, float(np.abs(a - b).max()))
    assert err < TOL, f"largest error {err:.3e}"
    return err


@pytest.mark.parametrize("case", ["llama", "qwen3_moe", "llama:int8", "llama-batched", "llama-sp2"])
def test_embeddings_match_the_reference(dirs, case):
    model = dirs[case.split("-")[0]]
    slots = 4 if case.endswith("batched") else 1
    unload = case == "llama"
    (ref, ref_health), (port, port_health) = (
        asyncio.run(_embed_all(pkg, model, slots, unload, sp=case.endswith("sp2"))) for pkg in PACKAGES
    )
    _assert_close(ref, port)
    if unload:
        # the SLO block's values are each server's own latencies
        assert sorted(port_health.pop("slo")) == sorted(ref_health.pop("slo"))
        assert port_health == ref_health
        assert port_health["model"] is None and port_health["after"][0] == 400


def test_streamed_plan_hidden_states_match_the_reference(dirs):
    from dnet_tpu.core.engine import LocalEngine as RefEngine
    from dnet_tpu_torch.core.engine import LocalEngine

    kw = dict(max_seq=32, param_dtype="float32", window_size=2, residency_size=1)
    ref = RefEngine(dirs["llama"], **kw)
    port = LocalEngine(dirs["llama"], device="cpu", **kw)
    try:
        assert port.plan.name == ref.plan.name == "sliding_fit"
        ids = [256, 72, 105, 33, 7, 81, 99, 12, 40]
        a, b = port.hidden_states(ids), np.asarray(ref.hidden_states(ids))
        assert a.shape == b.shape == (len(ids), port.config.hidden_size) and a.dtype == np.float32
        err = float(np.abs(a - b).max())
        assert err < TOL, f"largest error {err:.3e}"
        assert "__embed__" not in port.sessions
    finally:
        port.close()


def test_ring_answers_501_on_both():
    for pkg in PACKAGES:
        ring = importlib.import_module(f"{pkg}.api.ring")
        server, inference = _stack(pkg)
        inference.adapter = ring.RingApiAdapter("127.0.0.1:1", "grpc://127.0.0.1:2")
        inference.model_id = "tiny"
        inference.tokenizer = importlib.import_module(f"{pkg}.utils.tokenizer").ByteTokenizer()

        async def go():
            client = TestClient(TestServer(server.app))
            await client.start_server()
            try:
                r = await client.post("/v1/embeddings", json={"model": "tiny", "input": "hi"})
                return r.status, await r.json()
            finally:
                await client.close()

        status, body = asyncio.run(go())
        assert status == 501 and body == {
            "error": {"message": "embeddings unsupported on RingApiAdapter", "type": "not_implemented"}}, pkg
