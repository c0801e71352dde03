"""The port's settings against the reference's.

The CLIs take their defaults from DNET_API_* / DNET_SHARD_* as dnet_tpu's
do (dnet_tpu/config.py ApiSettings / ShardSettings, dnet_tpu/cli/api.py,
dnet_tpu/cli/shard.py, dnet_tpu/api/server.py), and a flag still wins.
Settings that change what the reference serves and that the port does not
serve yet are refused at load with 422 and a message naming the setting:
the prefix cache and speculation (with or without a draft model) under a
mesh.  Weight quantization (DNET_API_WEIGHT_QUANT_BITS 8 / 4), the prefix
cache, speculative decoding and the draft model, once refused, serve on a
single device; the ring API ships the configured weight_quant_bits to its
shards, which serve it too.
"""

import asyncio

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

API_ENV = {
    "DNET_API_MAX_SEQ_LEN": "8192",
    "DNET_API_PARAM_DTYPE": "float32",
    "DNET_API_HTTP_PORT": "9123",
    "DNET_API_GRPC_PORT": "59123",
    "DNET_API_HOST": "127.0.0.2",
    "DNET_API_MODELS_DIR": "/srv/models",
    "DNET_API_MAX_CONCURRENT_REQUESTS": "3",
    "DNET_API_REQUEST_TIMEOUT_S": "42.5",
}
SHARD_ENV = {
    "DNET_SHARD_HOST": "127.0.0.3",
    "DNET_SHARD_HTTP_PORT": "9200",
    "DNET_SHARD_GRPC_PORT": "59200",
    "DNET_SHARD_QUEUE_SIZE": "64",
    "DNET_SHARD_NAME": "s9",
    "DNET_SHARD_MODELS_DIR": "/srv/shard-models",
}


@pytest.fixture
def env(monkeypatch):
    """Set variables for both packages (the reference caches its settings)."""

    def set_env(values: dict):
        for k, v in values.items():
            monkeypatch.setenv(k, v)
        reset_settings_cache()

    yield set_env
    reset_settings_cache()


def _ref_api_resolved():
    """What dnet_tpu's API node serves with: its CLI's flags and the server's
    settings reads (dnet_tpu/api/server.py: max_seq, param_dtype, admission,
    timeout and models dir come from the settings)."""
    from dnet_tpu.cli.api import build_parser
    from dnet_tpu.config import get_settings

    args, s = build_parser().parse_args([]), get_settings().api
    return {"host": args.host, "http_port": args.http_port, "grpc_port": args.grpc_port,
            "models_dir": args.models_dir or s.models_dir, "max_seq_len": s.max_seq_len,
            "param_dtype": s.param_dtype, "max_concurrent": s.max_concurrent_requests,
            "request_timeout_s": s.request_timeout_s}


def _port_api_resolved(argv=()):
    from dnet_tpu_torch.cli.api import build_parser

    args = build_parser().parse_args(list(argv))
    return {k: getattr(args, k) for k in ("host", "http_port", "grpc_port", "models_dir", "max_seq_len",
                                          "param_dtype", "max_concurrent", "request_timeout_s")}


def test_api_defaults_match_the_reference_without_env():
    reset_settings_cache()
    assert _port_api_resolved() == _ref_api_resolved()


def test_api_cli_reads_the_reference_settings(env):
    env(API_ENV)
    got = _port_api_resolved()
    assert got == _ref_api_resolved()
    assert (got["max_seq_len"], got["param_dtype"], got["http_port"]) == (8192, "float32", 9123)


@pytest.mark.parametrize("flag,value,key,want", [
    ("--max-seq-len", "2048", "max_seq_len", 2048),
    ("--param-dtype", "bfloat16", "param_dtype", "bfloat16"),
    ("--http-port", "8088", "http_port", 8088),
    ("--max-concurrent", "5", "max_concurrent", 5),
])
def test_api_flag_wins_over_the_setting(env, flag, value, key, want):
    env(API_ENV)
    got = _port_api_resolved([flag, value])
    assert got[key] == want
    assert all(v == _ref_api_resolved()[k] for k, v in got.items() if k != key)


def _shard_args(port: bool, argv=()):
    if port:
        from dnet_tpu_torch.cli.shard import build_parser
    else:
        from dnet_tpu.cli.shard import build_parser
    args = build_parser().parse_args(list(argv))
    return {k: getattr(args, k) for k in ("host", "http_port", "grpc_port", "queue_size", "shard_name")}


def test_shard_cli_reads_the_reference_settings(env):
    assert _shard_args(True) == _shard_args(False)
    env(SHARD_ENV)
    assert _shard_args(True) == _shard_args(False) == {
        "host": "127.0.0.3", "http_port": 9200, "grpc_port": 59200, "queue_size": 64, "shard_name": "s9"}
    from dnet_tpu_torch.cli.shard import build_parser

    assert build_parser().parse_args([]).models_dir == "/srv/shard-models"
    assert _shard_args(True, ["--queue-size", "8"])["queue_size"] == 8


# ---- C2: refused at load ------------------------------------------------------


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    from tests.fakes.checkpoints import make_tiny_llama

    d = tmp_path_factory.mktemp("tiny_llama_settings")
    make_tiny_llama(d)
    return d


def _load(model_dir, mesh=None, slots=1, chat=None):
    """POST /v1/load_model to a fresh port server; (status, json body), the
    manager.  With `chat` (a chat request's body) the request is then sent
    too, and its (status, json body) replaces the load's when the load
    succeeded."""
    from dnet_tpu_torch.api.http import ApiHTTPServer
    from dnet_tpu_torch.api.inference import InferenceManager
    from dnet_tpu_torch.api.model_manager import LocalModelManager

    inference = InferenceManager(adapter=None, request_timeout_s=60.0, max_concurrent=2)
    manager = LocalModelManager(inference, max_seq=64, param_dtype="float32", device="cpu", mesh=mesh,
                                batch_slots=slots)
    app = ApiHTTPServer(inference, manager).app

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/v1/load_model", json={"model": str(model_dir)})
            if chat is None or r.status != 200:
                return r.status, await r.json()
            r = await client.post("/v1/chat/completions", json=chat)
            return r.status, await r.json()
        finally:
            await client.close()
            if inference.adapter is not None:
                await inference.adapter.shutdown()

    return asyncio.run(go()), manager


@pytest.mark.parametrize("name,value", [
    ("DNET_API_PREFIX_CACHE", "4"),
    ("DNET_API_SPEC_LOOKAHEAD", "3"),
    ("DNET_API_DRAFT_MODEL", "/srv/models/draft"),
])
def test_unported_setting_is_422_at_load(llama_dir, env, name, value):
    """Under a mesh (sp = 2) the prefix cache and speculation, once refused
    with 422 (ROADMAP A7.4), now load and serve a greedy chat; a draft model
    (given with a lookahead) is not resolved under a mesh, as the
    reference's manager does not resolve it there: prompt lookup drafts."""
    env({name: value, **({"DNET_API_SPEC_LOOKAHEAD": "3"} if name == "DNET_API_DRAFT_MODEL" else {})})
    chat = {"model": "m", "messages": [{"role": "user", "content": "abcabc"}], "max_tokens": 8,
            "temperature": 0.0}
    (status, body), manager = _load(llama_dir, mesh={"sp": 2}, chat=chat)
    assert status == 200, body
    assert body["usage"]["completion_tokens"] == 8
    engine = manager.engine
    assert type(engine).__name__ == "MeshEngine" and engine.sp == 2 and engine.draft is None
    if name == "DNET_API_PREFIX_CACHE":
        assert engine.prefix_cache is not None and engine.prefix_cache.stats["misses"] == 1
    else:
        assert engine.spec_lookahead == 3 and engine.spec_blocks >= 1


@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("name,value", [
    ("DNET_API_PREFIX_CACHE", "4"),
    ("DNET_API_SPEC_LOOKAHEAD", "3"),
    ("DNET_API_DRAFT_MODEL", "self"),
])
def test_speculation_and_prefix_settings_serve(llama_dir, env, name, value, slots):
    """The three settings once refused with 422 load on a single device, one
    slot and dense batched slots, and serve a greedy chat.  The draft model
    (given with a lookahead; `self` names the served checkpoint) drafts on
    the single sequence only, as the reference's manager resolves it."""
    values = {name: str(llama_dir) if value == "self" else value}
    if name == "DNET_API_DRAFT_MODEL":
        values["DNET_API_SPEC_LOOKAHEAD"] = "3"
    env(values)
    chat = {"model": "m", "messages": [{"role": "user", "content": "abcabc"}], "max_tokens": 8,
            "temperature": 0.0}
    (status, body), manager = _load(llama_dir, slots=slots, chat=chat)
    assert status == 200, body
    assert body["usage"]["completion_tokens"] >= 1
    engine = manager.engine
    inner = engine if slots == 1 else engine.eng
    if name == "DNET_API_PREFIX_CACHE":
        assert inner.prefix_cache is not None and "prefix_cache" in engine.stats()
    else:
        assert engine.spec_lookahead == 3
        assert (inner.draft is not None) == (name == "DNET_API_DRAFT_MODEL" and slots == 1)


def test_missing_draft_model_drafts_by_prompt_lookup(llama_dir, env, tmp_path):
    """A draft model that resolves to nothing logs a warning and the engine
    speculates by prompt lookup (the reference's manager)."""
    env({"DNET_API_SPEC_LOOKAHEAD": "3", "DNET_API_DRAFT_MODEL": str(tmp_path / "absent")})
    (status, body), manager = _load(llama_dir)
    assert status == 200, body
    assert manager.engine.spec_lookahead == 3 and manager.engine.draft is None


@pytest.mark.parametrize("bits", [8, 4])
def test_weight_quant_setting_serves(llama_dir, env, bits):
    """DNET_API_WEIGHT_QUANT_BITS 8 / 4 (once a 422) loads an engine whose
    layers and LM projection hold int8 / packed-int4 codes."""
    from dnet_tpu_torch.ops.quant import is_quantized

    env({"DNET_API_WEIGHT_QUANT_BITS": str(bits)})
    (status, body), manager = _load(llama_dir)
    assert status == 200, body
    engine = manager.engine
    assert engine.weight_quant_bits == bits and engine.stats()["weight_quant_bits"] == bits
    assert ("q4" if bits == 4 else "q") in engine.window_params[0]["wq"]
    head = "embed" if engine.config.tie_word_embeddings else "lm_head"
    assert is_quantized(engine.edge_params[head]["weight"])


def test_defaults_still_load(llama_dir, env):
    env({"DNET_API_WEIGHT_QUANT_BITS": "0", "DNET_API_PREFIX_CACHE": "0", "DNET_API_SPEC_LOOKAHEAD": "0"})
    (status, body), manager = _load(llama_dir)
    assert status == 200, body
    assert manager.engine is not None


# ---- the ring ships the configured weight_quant_bits ---------------------------


def _ring_bodies():
    from dnet_tpu_torch.api.ring_manager import RingModelManager, build_manual_topology
    from dnet_tpu_torch.core.types import DeviceInfo

    devices = [DeviceInfo(f"s{i}", "127.0.0.1", 8081 + i, 58081 + i) for i in range(2)]
    topo = build_manual_topology("tiny", 4, [{"instance": "s0", "layers": [0, 1]},
                                             {"instance": "s1", "layers": [2, 3]}], devices)
    manager = RingModelManager(None, None, api_callback_addr="127.0.0.1:58080")
    return manager.load_bodies(topo, "tiny", 64)


def test_ring_manager_ships_the_configured_weight_quant_bits(env):
    assert {b["weight_quant_bits"] for b in _ring_bodies().values()} == {0}
    env({"DNET_API_WEIGHT_QUANT_BITS": "8"})
    assert {b["weight_quant_bits"] for b in _ring_bodies().values()} == {8}
    env({"DNET_API_WEIGHT_QUANT_BITS": "4"})
    assert {b["weight_quant_bits"] for b in _ring_bodies().values()} == {4}


def test_shard_serves_the_shipped_weight_quant_bits(llama_dir, env):
    """The body the ring API sends under DNET_API_WEIGHT_QUANT_BITS=8 (once
    refused with 422) loads the shard with int8 weights."""
    from dnet_tpu_torch.shard.http import ShardHTTPServer
    from dnet_tpu_torch.shard.runtime import ShardRuntime
    from dnet_tpu_torch.shard.server import Shard

    class Adapter:  # the ring wiring a load resets and configures, not under test
        async def reset_topology(self):
            pass

        def configure_topology(self, next_addr):
            self.next_addr = next_addr

    env({"DNET_API_WEIGHT_QUANT_BITS": "8"})
    body = dict(_ring_bodies()["s0"], model_path=str(llama_dir), next_node=None)
    runtime = ShardRuntime("s0", device="cpu")
    app = ShardHTTPServer(Shard("s0", runtime, adapter=Adapter())).app

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/load_model", json=body)
            return r.status, await r.json()
        finally:
            await client.close()

    status, resp = asyncio.run(go())
    assert status == 200, resp
    assert runtime.compute.engine.weight_quant_bits == 8
    runtime.unload_model_core()
