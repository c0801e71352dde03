"""The port's HTTP server serving qwen3 and qwen3_moe against
dnet_tpu's on the same tiny checkpoints (tests/fakes/checkpoints.py).

Greedy chat and completions, streamed and aggregated, must be
byte-identical once the response id and created stamp are normalised
(tests/test_torch_serving.py's pattern), on every path the reference
serves these families through:

- single sequence (qwen3 and qwen3_moe; qwen2 and mixtral are held at the
  engine in tests/test_torch_qwen_families.py);
- dense batched slots (DNET_KV_PAGED unset; uniform and mixed qwen3_moe), a
  concurrent burst;
- paged + ragged batched slots (uniform qwen3_moe), a concurrent burst;
- a mixed (dense-prefix) qwen3_moe under paged + ragged slots, where the
  reference's mixed scans carry no attend hook and it decodes through its
  dense-gather paged path: its answer is 200 with the same text, which the
  port gives through its ragged kernel (its layer loop carries the hook);
- `mesh sp=2` (qwen3 and qwen3_moe), against the reference's
  `MeshEngine(pp=1, sp=2)`.

Both servers get logit_bias -100 on the byte tokenizer's EOS, so the tiny
models' streams run their full length.  The reference runs with
DNET_FLASH_INTERPRET=1, as its own tests run it.
"""

import asyncio
import json
import re

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

MAX_SEQ = 64
NO_EOS = {"257": -100.0}
CHAT = {"model": "tiny", "messages": [{"role": "user", "content": "Hi there"}], "max_tokens": 10,
        "temperature": 0, "logit_bias": NO_EOS}
REQUESTS = [
    ("/v1/chat/completions", dict(CHAT, stream=True)),
    ("/v1/chat/completions", CHAT),
    ("/v1/completions", {"model": "tiny", "prompt": "abc", "max_tokens": 6, "temperature": 0, "stream": True,
                         "logit_bias": NO_EOS}),
]
# a concurrent burst: prompts that land in different 8-token blocks
BURST = [dict(CHAT, stream=True, messages=[{"role": "user", "content": p}])
         for p in ("Hi", "Hello there, friend", "A quick brown fox jumps over it")]
PAGED = {"DNET_KV_PAGED": "1", "DNET_KV_RAGGED": "1", "DNET_KV_BLOCK_TOKENS": "8"}
SLOTS = 4


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNET_FLASH_INTERPRET", "1")
        mp.setenv("DNET_API_WARM_ON_LOAD", "0")  # the reference would compile every chunk width at load
        for name in PAGED:
            mp.delenv(name, raising=False)
        reset_settings_cache()
        yield
    reset_settings_cache()


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    import tests.fakes.checkpoints as ck

    dirs = {}
    for name, maker, overrides in (
        ("qwen3", "make_tiny_qwen3", {}),
        ("qwen3_moe", "make_tiny_qwen3_moe", {}),
        ("qwen3_moe_prefix", "make_tiny_qwen3_moe", {"mlp_only_layers": [0]}),
    ):
        d = tmp_path_factory.mktemp(f"tiny_{name}_serving")
        getattr(ck, maker)(d, overrides)
        dirs[name] = d
    return dirs


@pytest.fixture
def env(monkeypatch):
    def set_env(values):
        for k, v in values.items():
            monkeypatch.setenv(k, v)
        reset_settings_cache()

    yield set_env
    reset_settings_cache()


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


def _app(port: bool, slots: int = 1, sp: int = 1):
    if port:
        from dnet_tpu_torch.api.http import ApiHTTPServer
        from dnet_tpu_torch.api.inference import InferenceManager
        from dnet_tpu_torch.api.model_manager import LocalModelManager

        kw = {"device": "cpu"}
        if sp > 1:
            kw["mesh"] = {"sp": sp}
    else:
        from dnet_tpu.api.http import ApiHTTPServer
        from dnet_tpu.api.inference import InferenceManager
        from dnet_tpu.api.model_manager import LocalModelManager

        kw = {"mesh": {"pp": 1, "sp": sp}} if sp > 1 else {}
    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=max(slots, 2))
    manager = LocalModelManager(inference, max_seq=MAX_SEQ, param_dtype="float32", batch_slots=slots, **kw)
    return ApiHTTPServer(inference, manager).app, inference


async def _serve(app, inference, model_dir, requests, burst=False):
    """Load the model, then send each (path, body), one after another or all
    at once; returns the load's status and (status, raw body) per request,
    then /health's body."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        if r.status != 200:
            return r.status, await r.text(), None

        async def one(path, body):
            resp = await client.post(path, json=body)
            return resp.status, (await resp.read()).decode()

        if burst:
            out = await asyncio.gather(*(one(p, b) for p, b in requests))
        else:
            out = [await one(p, b) for p, b in requests]
        health = await (await client.get("/health")).json()
        return 200, out, health
    finally:
        await client.close()
        if inference.adapter is not None:
            await inference.adapter.shutdown()


def _held(model_dir, requests, burst=False, **kw):
    """Both servers on the same requests: every answer 200 and byte-identical
    after normalising; returns the port's /health."""
    rs, ref, _ = asyncio.run(_serve(*_app(False, **kw), model_dir, requests, burst))
    ps, port, health = asyncio.run(_serve(*_app(True, **kw), model_dir, requests, burst))
    assert (rs, ps) == (200, 200), (ref, port)
    for (r_status, r_body), (p_status, p_body) in zip(ref, port):
        assert r_status == p_status == 200, (r_body, p_body)
        assert _normalize(p_body) == _normalize(r_body)
    events = [ln for ln in port[0][1].splitlines() if ln.startswith("data: {")]
    assert json.loads(events[-1][6:])["usage"]["completion_tokens"] == 10
    return health


@pytest.mark.parametrize("family", ["qwen3", "qwen3_moe"])
def test_single_sequence_byte_identical(model_dirs, family):
    _held(model_dirs[family], REQUESTS)


@pytest.mark.parametrize("family", ["qwen3_moe", "qwen3_moe_prefix"])
def test_dense_batched_slots_burst_byte_identical(model_dirs, family):
    health = _held(model_dirs[family], [("/v1/chat/completions", b) for b in BURST], burst=True, slots=SLOTS)
    assert health["engine"]["kv_mode"] == "dense" and health["engine"]["active"] == 0


@pytest.mark.parametrize("family", ["qwen3_moe", "qwen3_moe_prefix"])
def test_paged_ragged_burst_byte_identical(model_dirs, env, family):
    """Uniform qwen3_moe through both servers' ragged kernels; the mixed
    (dense-prefix) one against the reference's dense-gather answer."""
    env(PAGED)
    health = _held(model_dirs[family], [("/v1/chat/completions", b) for b in BURST], burst=True, slots=SLOTS)
    engine = health["engine"]
    assert engine["kv_mode"] == "paged" and engine["active"] == 0 and engine["kv_blocks_used"] == 0
    assert engine["decode_steps"] > 0


@pytest.mark.parametrize("family", ["qwen3", "qwen3_moe"])
def test_mesh_sp2_byte_identical(model_dirs, family):
    """A 40-token prompt crosses the shard boundary at 32."""
    long_chat = dict(CHAT, stream=True, messages=[{"role": "user", "content": "Tell me a story"}])
    health = _held(model_dirs[family], REQUESTS + [("/v1/chat/completions", long_chat)], sp=2)
    assert health["engine"]["sp"] == 2 and health["engine"]["devices"] == ["cpu", "cpu"]
