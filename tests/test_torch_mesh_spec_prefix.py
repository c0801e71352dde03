"""Speculation and the prefix cache under a mesh: the port's MeshEngine at
sp = 2, pp = 2 and pp = 2 x sp = 2 (every rank on the CPU, f32, max_seq
64) against dnet_tpu's MeshEngine with the same `spec_lookahead` /
`prefix_cache_size` on the forced host devices, and the port's server
under --mesh against the reference's mesh server (max_seq 128).

Engines: a repetitive prompt (prompt lookup lands drafts), then a turn 2
that extends turn 1's prompt and reply (a prefix hit restores turn 1's
snapshot, every stage and rank of it): equal greedy ids on both turns,
and equal prefix-cache hits, misses and stores.  gpt_oss keeps its W-row
ring in the whole model's reading, so neither package speculates there
(`kv_rewindable`), and the prefix cache serves alone.  Served: greedy SSE
(streamed and not, a speculating request and a turn 2 that hits the
snapshot) byte-identical to the reference server's except `id` and
`created`, under --mesh pp=2 without the features and with them, and
under --mesh sp=2 with them.
"""

import asyncio
import json
import re

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.parallel.engine import MeshEngine

pytestmark = [pytest.mark.core, pytest.mark.parallel]

MAX_SEQ = 64
LOOKAHEAD = 3
PROMPT = [256] + list(b"abcabcabcabcabcabcabc")
MESHES = {"sp2": {"pp": 1, "sp": 2}, "pp2": {"pp": 2}, "pp2sp2": {"pp": 2, "sp": 2}}
CASES = [("llama", "sp2"), ("llama", "pp2"), ("llama", "pp2sp2"), ("deepseek_v2", "pp2"), ("gpt_oss", "pp2sp2")]


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNET_FLASH_INTERPRET", "1")
        mp.setenv("DNET_API_WARM_ON_LOAD", "0")
        reset_settings_cache()
        yield
    reset_settings_cache()


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory, tiny_llama_dir):
    from tests.fakes.checkpoints import make_tiny_deepseek_v2, make_tiny_gpt_oss

    oss = tmp_path_factory.mktemp("msp_gpt_oss")
    make_tiny_gpt_oss(oss)
    ds = tmp_path_factory.mktemp("msp_deepseek")
    make_tiny_deepseek_v2(ds)
    return {"llama": tiny_llama_dir, "gpt_oss": oss, "deepseek_v2": ds}


def _two_turns(engine, decoding) -> tuple:
    a = [r.token_id for r in engine.generate(PROMPT, decoding, max_tokens=16, nonce="t1")]
    turn2 = PROMPT + a[:4] + list(b"xyz")
    b = [r.token_id for r in engine.generate(turn2, decoding, max_tokens=8, nonce="t2")]
    return a, b


@pytest.mark.parametrize("family,mesh_id", CASES)
def test_greedy_ids_and_prefix_hits_match_the_reference(model_dirs, eight_devices, family, mesh_id):
    from dnet_tpu.parallel.engine import MeshEngine as RefMesh

    mesh = MESHES[mesh_id]
    kw = dict(max_seq=MAX_SEQ, param_dtype="float32", spec_lookahead=LOOKAHEAD, prefix_cache_size=4)
    n = mesh["pp"] * mesh.get("sp", 1)
    port = MeshEngine(model_dirs[family], devices=["cpu"] * n, **{"sp": 1, **mesh}, **kw)
    ref = RefMesh(model_dirs[family], **mesh, **kw)
    assert _two_turns(port, DecodingParams()) == _two_turns(ref, RefDecoding())
    stats = port.stats()
    assert {k: stats["prefix_cache"][k] for k in ("hits", "misses", "stores")} == ref.prefix_cache.stats
    assert stats["prefix_cache"]["hits"] == 1
    speculates = family != "gpt_oss"
    assert (stats["spec_blocks"] > 0) == speculates and stats["spec_lookahead"] == LOOKAHEAD


def test_a_snapshot_keeps_every_stage_and_rank_in_place(model_dirs):
    """A stored snapshot is a copy of the session's cache in its layout
    (per stage run, per sp rank), each tensor on its own rank's device,
    and a hit restores it there."""
    eng = MeshEngine(model_dirs["llama"], pp=2, sp=2, max_seq=MAX_SEQ, param_dtype="float32",
                     devices=["cpu"] * 4, prefix_cache_size=4)
    eng.prefill("a", PROMPT)
    [snap] = eng.prefix_cache._index.values()
    live = eng.sessions["a"].kv
    assert len(snap) == len(eng.stages.runs) == 2 and all(len(run) == 2 for run in snap)
    for s_run, l_run in zip(snap, live):
        for s, c in zip(s_run, l_run):
            assert s["k"].device == c["k"].device and s["k"].data_ptr() != c["k"].data_ptr()
            assert bool((s["k"] == c["k"]).all())
    eng.prefill("b", PROMPT + [1, 2, 3])
    assert eng.prefix_cache.stats["hits"] == 1 and eng.sessions["b"].pos == len(PROMPT) + 3


# ---- served --------------------------------------------------------------

SERVE_MAX_SEQ = 128  # turn 2 carries turn 1's reply (random weights' bytes, 3 a token as text)
CHAT = {"model": "tiny", "messages": [{"role": "user", "content": "abcabcabcabcabc"}], "max_tokens": 12,
        "temperature": 0}


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


async def _serve(app, model_dir, turns):
    """Load, then send each chat body in turn; a turn 2 (`None`) resends the
    first turn with its reply appended and a new user message."""
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        assert r.status == 200, await r.text()
        out, reply = [], None
        for body in turns:
            if body is None:
                body = dict(CHAT, messages=CHAT["messages"] + [{"role": "assistant", "content": reply},
                                                               {"role": "user", "content": "abcabc again"}])
            resp = await client.post("/v1/chat/completions", json=body)
            text = (await resp.read()).decode()
            out.append((resp.status, text))
            if reply is None and not body.get("stream"):
                reply = json.loads(text)["choices"][0]["message"]["content"]
        return out
    finally:
        await client.close()


def _reference(model_dir, mesh, features):
    from dnet_tpu.api.http import ApiHTTPServer
    from dnet_tpu.api.inference import InferenceManager
    from dnet_tpu.api.model_manager import LocalModelManager

    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=2)
    manager = LocalModelManager(inference, max_seq=SERVE_MAX_SEQ, param_dtype="float32", mesh=mesh,
                                prefix_cache=features.get("DNET_API_PREFIX_CACHE", 0),
                                spec_lookahead=features.get("DNET_API_SPEC_LOOKAHEAD", 0))
    return ApiHTTPServer(inference, manager).app, inference


def _port(mesh):
    from dnet_tpu_torch.api.http import ApiHTTPServer
    from dnet_tpu_torch.api.inference import InferenceManager
    from dnet_tpu_torch.api.model_manager import LocalModelManager

    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=2)
    manager = LocalModelManager(inference, max_seq=SERVE_MAX_SEQ, param_dtype="float32", device="cpu", mesh=mesh)
    return ApiHTTPServer(inference, manager).app, inference, manager


@pytest.mark.parametrize("mesh_id,features", [
    ("pp2", {}),
    ("pp2", {"DNET_API_SPEC_LOOKAHEAD": 3, "DNET_API_PREFIX_CACHE": 4}),
    ("sp2", {"DNET_API_SPEC_LOOKAHEAD": 3, "DNET_API_PREFIX_CACHE": 4}),
], ids=["pp2", "pp2-spec-prefix", "sp2-spec-prefix"])
def test_served_sse_is_byte_identical_to_the_reference(model_dirs, eight_devices, monkeypatch, mesh_id, features):
    for k, v in features.items():
        monkeypatch.setenv(k, str(v))
    mesh = MESHES[mesh_id]
    turns = [CHAT, dict(CHAT, stream=True), None, dict(CHAT, stream=True, max_tokens=20,
                                                      messages=[{"role": "user", "content": "Tell me a story"}])]
    ref_app, ref_inf = _reference(model_dirs["llama"], mesh, features)
    want = asyncio.run(_serve(ref_app, model_dirs["llama"], turns))
    asyncio.run(ref_inf.adapter.shutdown())
    app, inference, manager = _port(mesh)
    got = asyncio.run(_serve(app, model_dirs["llama"], turns))
    asyncio.run(inference.adapter.shutdown())
    assert [s for s, _ in got] == [s for s, _ in want] == [200] * 4
    for (_, g), (_, w) in zip(got, want):
        assert _normalize(g) == _normalize(w)
    engine = manager.engine
    assert (engine.pp, engine.sp) == (mesh["pp"], mesh.get("sp", 1))
    if features:
        assert engine.spec_blocks > 0 and engine.prefix_cache.stats["hits"] >= 1
