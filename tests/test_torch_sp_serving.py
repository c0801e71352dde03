"""Sequence-parallel serving: the port's HTTP server with a mesh of sp = 2
ranks on the CPU against dnet_tpu's mesh server on the same tiny
checkpoint.  Greedy responses must be byte-identical except for the
response id and the created stamp (tests/test_torch_serving.py's pattern).

The reference serves `MeshEngine(pp=1, sp=2)`: its `--mesh sp=2` would
fill pp with the forced CPU devices left over, which changes its program,
not its arithmetic.  What the port does not serve under a mesh answers 422
and names its setting; `--mesh sp=2` on CUDA refuses to start on a machine
with fewer cards; DNET_MESH_* reaches the server as --mesh's default.
"""

import asyncio
import json
import re
import socket
import subprocess
import sys
import time

import httpx
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

CHAT = {
    "model": "tiny",
    "messages": [{"role": "user", "content": "Hello there"}],
    "max_tokens": 12,
    "temperature": 0,
}
# a prompt of 40 tokens with the byte tokenizer's chat template: its KV
# crosses the shard boundary at 32 in prefill, and decode writes rank 1
LONG_CHAT = dict(CHAT, messages=[{"role": "user", "content": "Tell me a story"}])


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
    manager = LocalModelManager(inference, max_seq=64, param_dtype="float32", mesh={"pp": 1, "sp": 2})
    return ApiHTTPServer(inference, manager).app


def _port_app(mesh=None, batch_slots=1, kv_bits=0):
    from dnet_tpu_torch.api.http import ApiHTTPServer
    from dnet_tpu_torch.api.inference import InferenceManager
    from dnet_tpu_torch.api.model_manager import LocalModelManager

    inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=2)
    manager = LocalModelManager(inference, max_seq=64, param_dtype="float32", device="cpu",
                                batch_slots=batch_slots, kv_bits=kv_bits, mesh=mesh or {"sp": 2})
    return ApiHTTPServer(inference, manager).app, manager, inference


async def _serve(app, model_dir, requests, inference=None):
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
        if inference is not None and inference.adapter is not None:
            await inference.adapter.shutdown()


def test_sse_and_aggregate_byte_identical(tiny_llama_dir, no_warmup):
    requests = [
        ("POST", "/v1/chat/completions", dict(CHAT, stream=True)),
        ("POST", "/v1/chat/completions", CHAT),
        ("POST", "/v1/chat/completions", dict(LONG_CHAT, stream=True)),
        ("POST", "/v1/completions", {"model": "tiny", "prompt": "abc", "max_tokens": 6, "temperature": 0,
                                     "echo": True, "stream": True}),
    ]
    ref = asyncio.run(_serve(_reference_app(), tiny_llama_dir, requests))
    app, manager, inference = _port_app()
    port = asyncio.run(_serve(app, tiny_llama_dir, requests + [("GET", "/health", None)], inference))
    assert [s for s, _ in port] == [200] * 6 and [s for s, _ in ref] == [200] * 5
    for (_, rb), (_, pb) in zip(ref[1:], port[1:5]):
        assert _normalize(pb) == _normalize(rb)
    events = [ln for ln in port[3][1].splitlines() if ln.startswith("data: {")]
    usage = json.loads(events[-1][6:])["usage"]
    assert usage["prompt_tokens"] > 32 and usage["completion_tokens"] == 12  # across the boundary
    engine = json.loads(port[5][1])["engine"]
    assert engine["sp"] == 2 and engine["devices"] == ["cpu", "cpu"]
    assert engine["kv_bytes_per_rank"] == [engine["kv_bytes"] // 2] * 2 > [0, 0]
    assert type(manager.engine).__name__ == "MeshEngine"


@pytest.mark.parametrize("case,match", [
    (dict(mesh={"sp": 2, "tp": 2}), "tp=2"),
    (dict(mesh={"sp": 2, "pp": 2}), "pp=2"),
    (dict(mesh={"sp": 2, "dp": 2}), "dp=2"),
    (dict(kv_bits=8, batch_slots=2), "--batch-slots 2"),
    (dict(kv_bits=4, mesh={"sp": 2, "tp": 2}), "tp=2"),
    (dict(batch_slots=2), "--batch-slots 2"),
    (dict(model="gpt_oss", batch_slots=2), "--batch-slots 2"),
])
def test_unported_under_a_mesh_is_422(tiny_llama_dir, tmp_path, case, match):
    """What stays refused under a mesh: pp / tp / dp and --batch-slots > 1,
    with a quantized cache or another family too (those serve under sp
    alone: tests/test_torch_sp_families_serving.py)."""
    model_dir = tiny_llama_dir
    if case.get("model") == "gpt_oss":
        from tests.fakes.checkpoints import make_tiny_gpt_oss

        make_tiny_gpt_oss(tmp_path)
        model_dir = tmp_path
    app, manager, inference = _port_app(case.get("mesh"), case.get("batch_slots", 1), case.get("kv_bits", 0))
    [(status, body)] = asyncio.run(_serve(app, model_dir, [], inference))
    assert status == 422, body
    err = json.loads(body)["error"]
    assert err["type"] == "invalid_request_error" and match in err["message"], err
    assert manager.engine is None


def _args(argv):
    from dnet_tpu_torch.cli.api import build_parser

    return build_parser().parse_args(argv)


def test_mesh_defaults_to_the_dnet_mesh_settings(monkeypatch):
    from dnet_tpu_torch.api.model_manager import active_mesh
    from dnet_tpu_torch.api.server import resolve_mesh

    assert resolve_mesh(_args([])) is None
    assert resolve_mesh(_args(["--mesh", "sp=2"])) == {"sp": 2}
    monkeypatch.setenv("DNET_MESH_SP", "2")
    assert resolve_mesh(_args([])) == {"pp": 0, "tp": 1, "dp": 1, "sp": 2}
    assert active_mesh(resolve_mesh(_args([]))) is not None
    assert resolve_mesh(_args(["--mesh", "sp=4"])) == {"sp": 4}  # the flag wins
    assert active_mesh({"sp": 1}) is None  # as the reference: one rank is no mesh
    with pytest.raises(ValueError, match="unknown mesh axis"):
        resolve_mesh(_args(["--mesh", "xp=2"]))
    monkeypatch.setenv("DNET_MESH_COORDINATOR", "10.0.0.1:1234")
    with pytest.raises(ValueError, match="DNET_MESH_COORDINATOR"):
        resolve_mesh(_args([]))


def test_mesh_refuses_to_start_with_fewer_cards(monkeypatch):
    """--mesh sp=2 on CUDA with one card: no server, exit code 2, the
    build_mesh message; ranks are never co-located on their own."""
    from dnet_tpu_torch.cli import api
    from dnet_tpu_torch.parallel.mesh import rank_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr("dnet_tpu_torch.api.server.serve", lambda args: pytest.fail("server started"))
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        rank_devices(2, "cuda")
    assert rank_devices(1, "cuda") == [torch.device("cuda", 0)]
    assert rank_devices(2, "cpu") == [torch.device("cpu")] * 2
    assert api.main(["--mesh", "sp=2", "--http-port", "1"]) == 2
    assert api.main(["--mesh", "sp=2", "--hostfile", "h", "--device", "cpu"]) == 2


def test_cli_serves_a_mesh_on_the_cpu(tiny_llama_dir):
    """`--mesh sp=2 --device cpu` end to end in a real process: /health
    shows both ranks, a greedy request answers 200."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dnet_tpu_torch.cli.api", "--model", str(tiny_llama_dir), "--device", "cpu",
         "--mesh", "sp=2", "--host", "127.0.0.1", "--http-port", str(port), "--max-seq-len", "64",
         "--param-dtype", "float32"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(120):
            try:
                health = httpx.get(base + "/health", timeout=2).json()
                if health.get("model"):
                    break
            except httpx.HTTPError:
                pass
            assert proc.poll() is None, "server exited"
            time.sleep(0.5)
        else:
            pytest.fail("server not ready")
        r = httpx.post(base + "/v1/chat/completions", json=CHAT, timeout=60)
        assert r.status_code == 200 and r.json()["usage"]["completion_tokens"] == 12
        engine = health["engine"]
        assert engine["sp"] == 2 and len(engine["kv_bytes_per_rank"]) == 2
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
