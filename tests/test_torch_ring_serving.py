"""A real port ring on the CPU: two `dnet_tpu_torch.cli.shard --device cpu`
processes and one `dnet_tpu_torch.cli.api --hostfile` process on
loopback, wired by POST /v1/prepare_topology_manual ([0,1] / [2,3]) and
POST /v1/load_model, serving greedy chat over real gRPC.  The SSE must be
byte-identical, apart from `id` and `created`, to the port's
single-process server on the same checkpoint.  Both serve bf16 parameters,
the deployment default: the hops then carry the hidden state in its own
dtype (the wire dtype is bf16), and nothing rounds that the single process
does not round.
"""

import asyncio
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import httpx
import pytest

pytestmark = [pytest.mark.ring, pytest.mark.api, pytest.mark.http]

ROOT = Path(__file__).resolve().parents[1]
MAX_SEQ = 64
CHAT = {"model": "tiny", "messages": [{"role": "user", "content": "Hello there"}],
        "max_tokens": 12, "temperature": 0}

# run a module as __main__ in a process where importing jax, jaxlib or
# dnet_tpu (but not dnet_tpu_torch) raises
_GUARDED = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "dnet_tpu"):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_health(base: str, proc, key: str = "status", timeout: float = 90.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stdout.read()
        try:
            body = httpx.get(base + "/health", timeout=2).json()
            if body.get(key):
                return body
        except httpx.HTTPError:
            pass
        time.sleep(0.2)
    raise TimeoutError(f"{base} not ready")


class CpuRing:
    """Two shards and an API node as processes; `guarded` blocks jax and
    dnet_tpu imports in all three.  The shards take `shard_args` (default:
    no UDP discovery), the API `api_args` (default: --hostfile over the
    shards)."""

    def __init__(self, tmp_path: Path, guarded: bool = False, shard_args=("--discovery", "none"), api_args=None):
        self.procs = []
        self.guarded = guarded
        env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_", "DNET_"))}
        env["PYTHONPATH"] = str(ROOT)
        self.env = env
        self.shards = [(f"s{i}", _free_port(), _free_port()) for i in range(2)]
        self.hostfile = tmp_path / "hostfile"
        self.hostfile.write_text("".join(f"{n} 127.0.0.1 {h} {g}\n" for n, h, g in self.shards))
        for name, http, grpc_port in self.shards:
            self._spawn("dnet_tpu_torch.cli.shard", "--device", "cpu", "--host", "127.0.0.1",
                        "--http-port", str(http), "--grpc-port", str(grpc_port), "--shard-name", name,
                        *shard_args)
        for (_, http, _), proc in zip(self.shards, self.procs):
            _wait_health(f"http://127.0.0.1:{http}", proc)
        self.start_api(api_args)

    def start_api(self, api_args=None) -> None:
        """Spawn the API node (`api_args`, default --hostfile) and wait for
        it; it is the last process."""
        self.http = _free_port()
        self._spawn("dnet_tpu_torch.cli.api", "--device", "cpu", "--host", "127.0.0.1",
                    "--http-port", str(self.http), "--grpc-port", str(_free_port()),
                    *(api_args or ["--hostfile", str(self.hostfile)]), "--max-seq-len", str(MAX_SEQ),
                    "--param-dtype", "bfloat16")
        self.base = f"http://127.0.0.1:{self.http}"
        _wait_health(self.base, self.procs[-1])

    def stop_api(self) -> tuple:
        """SIGTERM the API node; its (exit code, output)."""
        proc = self.procs.pop()
        proc.send_signal(signal.SIGTERM)
        try:
            text, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        return proc.returncode, text

    def _spawn(self, module: str, *args: str) -> None:
        cmd = ([sys.executable, "-c", _GUARDED, module] if self.guarded else [sys.executable, "-m", module])
        self.procs.append(subprocess.Popen([*cmd, *args], cwd=ROOT, env=self.env, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))

    def load(self, model_dir, split=([0, 1], [2, 3])) -> None:
        """Prepare the manual topology (s0 and s1 over `split`) and load."""
        r = httpx.post(self.base + "/v1/prepare_topology_manual", timeout=30, json={
            "model": str(model_dir),
            "assignments": [{"instance": f"s{i}", "layers": list(ls)} for i, ls in enumerate(split)],
        })
        assert r.status_code == 200, r.text
        topo = r.json()["topology"]
        assert [(a["instance"], a["next_instance"]) for a in topo["assignments"]] == [("s0", "s1"), ("s1", "s0")]
        r = httpx.post(self.base + "/v1/load_model", json={"model": str(model_dir)}, timeout=120)
        assert r.status_code == 200, r.text

    def shard_health(self, i: int) -> dict:
        return httpx.get(f"http://127.0.0.1:{self.shards[i][1]}/health", timeout=5).json()

    def stop(self) -> list:
        """SIGTERM all; returns each process's (exit code, output)."""
        for p in reversed(self.procs):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        out = []
        for p in self.procs:
            try:
                text, _ = p.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
            out.append((p.returncode, text))
        return out


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


def _single_process(model_dir, requests):
    from aiohttp.test_utils import TestClient, TestServer

    from dnet_tpu_torch.api.http import ApiHTTPServer
    from dnet_tpu_torch.api.inference import InferenceManager
    from dnet_tpu_torch.api.model_manager import LocalModelManager

    async def go():
        inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=2)
        manager = LocalModelManager(inference, max_seq=MAX_SEQ, param_dtype="bfloat16", device="cpu")
        client = TestClient(TestServer(ApiHTTPServer(inference, manager).app))
        await client.start_server()
        try:
            r = await client.post("/v1/load_model", json={"model": str(model_dir)})
            assert r.status == 200
            out = []
            for body in requests:
                resp = await client.post("/v1/chat/completions", json=body)
                out.append((resp.status, (await resp.read()).decode()))
            return out
        finally:
            await client.close()

    return asyncio.run(go())


@pytest.fixture(scope="module")
def ring(tiny_llama_dir, tmp_path_factory):
    r = CpuRing(tmp_path_factory.mktemp("ring"))
    try:
        r.load(tiny_llama_dir)
        yield r
    finally:
        outcomes = r.stop()
    for code, text in outcomes:
        assert code == 0, text


def _ring_requests(ring, requests):
    out = []
    for body in requests:
        resp = httpx.post(ring.base + "/v1/chat/completions", json=body, timeout=120)
        out.append((resp.status_code, resp.text))
    return out


def test_ring_sse_is_byte_identical_to_single_process(ring, tiny_llama_dir):
    requests = [dict(CHAT, stream=True),
                dict(CHAT, stream=True, messages=[{"role": "user", "content": "Tell me a story"}],
                     max_tokens=20)]
    got = _ring_requests(ring, requests)
    want = _single_process(tiny_llama_dir, requests)
    for (gs, gbody), (ws, wbody) in zip(got, want):
        assert gs == ws == 200
        assert gbody.endswith("data: [DONE]\n\n")
        assert _normalize(gbody) == _normalize(wbody)


def test_ring_aggregate_response_matches_single_process(ring, tiny_llama_dir):
    got = _ring_requests(ring, [CHAT])[0]
    want = _single_process(tiny_llama_dir, [CHAT])[0]
    assert got[0] == want[0] == 200
    g, w = json.loads(got[1]), json.loads(want[1])
    assert g["choices"] == w["choices"] and g["usage"] == w["usage"]


def test_shards_report_their_hops(ring):
    """/health on each shard: its layers, the lossless codec, the hidden
    frames s0 sent and s1 received, and no column kernel launched (the
    CPU takes the plain versions)."""
    _ring_requests(ring, [CHAT])
    s0, s1 = ring.shard_health(0), ring.shard_health(1)
    assert s0["layers"] == [0, 1] and s1["layers"] == [2, 3]
    assert s0["wire_codec"] == s1["wire_codec"] == "lossless"
    assert s0["wire"]["frames_encoded"] == s1["wire"]["frames_decoded"] > 0
    assert s0["wire"]["bytes_encoded"] == s1["wire"]["bytes_decoded"]
    assert s0["wire"]["decode_hop_bytes"] == 64 * 2  # one bf16 row of hidden 64
    assert s0["sessions"] == s1["sessions"] == 0  # every request reset its KV
    assert not any(s0["kernels"].values()) and not any(s1["kernels"].values())


def test_topology_and_load_errors(ring, tiny_llama_dir):
    r = httpx.post(ring.base + "/v1/prepare_topology_manual", timeout=30, json={
        "model": str(tiny_llama_dir), "assignments": [{"instance": "s0", "layers": [0, 1]}]})
    assert r.status_code == 400 and "exactly once" in r.text
    r = httpx.post(ring.base + "/v1/prepare_topology_manual", timeout=30, json={
        "model": str(tiny_llama_dir), "assignments": [{"instance": "nope", "layers": [0, 1, 2, 3]}]})
    assert r.status_code == 400 and "unknown instance" in r.text
    # a refused shard option answers 422 from the shard itself (a mesh-backed
    # shard; lanes and ring speculation, refused here until they were
    # ported, serve)
    r = httpx.post(f"http://127.0.0.1:{ring.shards[0][1]}/load_model", timeout=60,
                   json={"model_path": str(tiny_llama_dir), "layers": [0, 1], "mesh_tp": 2})
    assert r.status_code == 422 and "mesh_tp" in r.text
