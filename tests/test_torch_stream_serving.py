"""A port ring whose tail shard streams its weights, against a dnet_tpu ring
with the same topology, as real processes on loopback.

Each ring is two shard processes and an API process (`--hostfile`), wired
by POST /v1/prepare_topology_manual: shard s0 holds layers [0, 1]
resident, shard s1 layers [2, 3] with `window_size` 1 and
`residency_size` 1 (an offload plan: one layer on the device at a time,
read from the repack cache each shard writes under DNET_SHARD_REPACK_DIR).
Greedy chat, streamed and not, must be byte-identical between the two
rings once `id` and `created` are normalised.  Both serve f32 parameters
(the hops carry bf16 in both).  The tail's /health reports the plan and
the weight cache's loads; /cleanup_repacked answers as the reference's:
409 on the streaming shard while its model is loaded, then, after
/unload_model, 200 with the whole cache directory removed.
"""

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
        "max_tokens": 10, "temperature": 0}
ASSIGNMENTS = [{"instance": "s0", "layers": [0, 1]},
               {"instance": "s1", "layers": [2, 3], "window_size": 1, "residency_size": 1}]
PACKAGES = {"port": "dnet_tpu_torch", "ref": "dnet_tpu"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


class Ring:
    """Two shards and an API node of one package, as processes."""

    def __init__(self, kind: str, tmp: Path):
        pkg = PACKAGES[kind]
        env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_", "DNET_"))}
        self.repack = tmp / "repack"
        env.update(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu", DNET_SHARD_REPACK_DIR=str(self.repack),
                   DNET_API_MAX_SEQ_LEN=str(MAX_SEQ), DNET_API_PARAM_DTYPE="float32",
                   DNET_API_WARM_ON_LOAD="0")
        self.procs = []
        self.shards = [(f"s{i}", _free_port(), _free_port()) for i in range(2)]
        hostfile = tmp / "hostfile"
        hostfile.write_text("".join(f"{n} 127.0.0.1 {h} {g}\n" for n, h, g in self.shards))
        device = ["--device", "cpu"] if kind == "port" else []
        for name, http, grpc_port in self.shards:
            self._spawn(env, f"{pkg}.cli.shard", *device, "--host", "127.0.0.1", "--http-port", str(http),
                        "--grpc-port", str(grpc_port), "--shard-name", name, "--discovery", "none")
        self.http = _free_port()
        extra = ["--max-seq-len", str(MAX_SEQ), "--param-dtype", "float32"] if kind == "port" else []
        self._spawn(env, f"{pkg}.cli.api", *device, *extra, "--host", "127.0.0.1", "--http-port", str(self.http),
                    "--grpc-port", str(_free_port()), "--hostfile", str(hostfile))
        self.base = f"http://127.0.0.1:{self.http}"
        self.urls = [f"http://127.0.0.1:{h}" for _, h, _ in self.shards]

    def _spawn(self, env, module: str, *args: str) -> None:
        self.procs.append(subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def wait(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        for url, proc in zip(self.urls + [self.base], self.procs):
            while True:
                assert proc.poll() is None, proc.stdout.read()
                try:
                    if httpx.get(url + "/health", timeout=2).status_code == 200:
                        break
                except httpx.HTTPError:
                    pass
                assert time.monotonic() < deadline, f"{url} not ready"
                time.sleep(0.2)

    def load(self, model_dir) -> None:
        r = httpx.post(self.base + "/v1/prepare_topology_manual", timeout=30,
                       json={"model": str(model_dir), "assignments": ASSIGNMENTS})
        assert r.status_code == 200, r.text
        r = httpx.post(self.base + "/v1/load_model", json={"model": str(model_dir)}, timeout=120)
        assert r.status_code == 200, r.text

    def chat(self, body: dict) -> tuple:
        resp = httpx.post(self.base + "/v1/chat/completions", json=body, timeout=120)
        return resp.status_code, resp.text

    def stop(self) -> list:
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


@pytest.fixture(scope="module")
def rings(tiny_llama_dir, tmp_path_factory):
    made = {k: Ring(k, tmp_path_factory.mktemp(f"stream-{k}")) for k in PACKAGES}
    try:
        for r in made.values():
            r.wait()
        for r in made.values():
            r.load(tiny_llama_dir)
        yield made
    finally:
        outcomes = [o for r in made.values() for o in r.stop()]
    for code, text in outcomes:
        assert code == 0, text[-3000:]


def test_streamed_ring_sse_is_byte_identical_to_the_reference_ring(rings):
    for body in (dict(CHAT, stream=True), CHAT,
                 dict(CHAT, stream=True, messages=[{"role": "user", "content": "Tell me a story"}])):
        (ps, pbody), (rs, rbody) = rings["port"].chat(body), rings["ref"].chat(body)
        assert ps == rs == 200, (pbody, rbody)
        assert _normalize(pbody) == _normalize(rbody)
    h0, h1 = (httpx.get(u + "/health", timeout=5).json() for u in rings["port"].urls)
    assert h0["engine"]["weight_policy"] == "fit" and "weight_cache" not in h0["engine"]
    assert h1["engine"]["weight_policy"] == "offload"
    wc = h1["engine"]["weight_cache"]
    assert wc["loads"] > 0 and wc["max_resident"] == 1 and wc["h2d_bytes"] > 0
    assert len(list(rings["port"].repack.rglob("layer_*.safetensors"))) == 2


def test_cleanup_repacked_answers_as_the_reference(rings):
    answers = {}
    for kind, ring in rings.items():
        busy = httpx.post(ring.urls[1] + "/cleanup_repacked", timeout=30)
        r = httpx.post(ring.urls[1] + "/unload_model", timeout=30)
        assert r.status_code == 200, r.text
        done = httpx.post(ring.urls[1] + "/cleanup_repacked", timeout=30)
        answers[kind] = (busy.status_code, busy.json(), done.status_code, done.json())
        assert not ring.repack.exists() or not any(ring.repack.iterdir())
    (pb, pbody, pd, pdone), (rb, rbody, rd, rdone) = answers["port"], answers["ref"]
    assert pb == rb == 409 and pbody == rbody
    assert pd == rd == 200 and set(pdone) == set(rdone) == {"status", "removed", "freed_bytes"}
    assert pdone["removed"] == str(rings["port"].repack) and rdone["removed"] == str(rings["ref"].repack)
    assert pdone["freed_bytes"] > 0 and rdone["freed_bytes"] > 0
