"""The port's package boundary: it imports no jax and nothing of dnet_tpu,
and it runs on CUDA unless told otherwise."""

import os
import re
import signal
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import httpx
import pytest
import torch

pytestmark = pytest.mark.core

ROOT = Path(__file__).resolve().parents[1]
PORT_PKG = ROOT / "dnet_tpu_torch"

# imports of jax / jaxlib / dnet_tpu (but not dnet_tpu_torch) at any indent
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|dnet_tpu)(?![A-Za-z0-9_])", re.MULTILINE
)

_GUARDED_SERVER = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "dnet_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import dnet_tpu_torch
    for m in pkgutil.walk_packages(dnet_tpu_torch.__path__, "dnet_tpu_torch."):
        importlib.import_module(m.name)

    from dnet_tpu_torch.utils.checkpoint import save_checkpoint
    rng = np.random.default_rng(0)
    cfg = {"model_type": "llama", "vocab_size": 261, "hidden_size": 32,
           "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 8, "tie_word_embeddings": False}
    w = lambda *s: rng.normal(0, 0.05, size=s).astype(np.float32)
    t = {"model.embed_tokens.weight": w(261, 32), "model.norm.weight": np.ones(32, np.float32),
         "lm_head.weight": w(261, 32)}
    for i in range(2):
        p = f"model.layers.{i}."
        for n, s in [("input_layernorm.weight", (32,)), ("post_attention_layernorm.weight", (32,)),
                     ("self_attn.q_proj.weight", (32, 32)), ("self_attn.k_proj.weight", (16, 32)),
                     ("self_attn.v_proj.weight", (16, 32)), ("self_attn.o_proj.weight", (32, 32)),
                     ("mlp.gate_proj.weight", (64, 32)), ("mlp.up_proj.weight", (64, 32)),
                     ("mlp.down_proj.weight", (32, 64))]:
            t[p + n] = w(*s)
    save_checkpoint(sys.argv[1], cfg, t)

    from dnet_tpu_torch.cli.api import main
    sys.exit(main(["--model", sys.argv[1], "--device", "cpu", "--host", "127.0.0.1",
                   "--http-port", sys.argv[2], "--max-seq-len", "64",
                   "--param-dtype", "float32", *sys.argv[3:]]))
    """
)


def test_no_jax_or_reference_imports_in_source():
    files = sorted(PORT_PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert not offenders, offenders
    # the pattern itself: catches the reference, spares the port
    assert _FORBIDDEN.search("from dnet_tpu.core import engine")
    assert _FORBIDDEN.search("    import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from dnet_tpu_torch.core import engine")


def _serve_one_guarded(tmp_path, extra_args=(), extra_env=None) -> dict:
    """Run the CLI in a process where importing jax or dnet_tpu raises,
    serve one greedy chat request, and return /health as it was then."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_", "DNET_"))}
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra_env or {})
    proc = subprocess.Popen(
        [sys.executable, "-c", _GUARDED_SERVER, str(tmp_path / "ckpt"), str(port), *extra_args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                if httpx.get(base + "/health", timeout=2).json().get("model"):
                    break
            except httpx.HTTPError:
                pass
            time.sleep(0.2)
        assert proc.poll() is None, proc.stdout.read()
        r = httpx.post(
            base + "/v1/chat/completions",
            json={"model": "m", "messages": [{"role": "user", "content": "hi"}],
                  "max_tokens": 5, "temperature": 0},
            timeout=30,
        )
        assert r.status_code == 200, r.text
        assert r.json()["usage"]["completion_tokens"] == 5
        health = httpx.get(base + "/health", timeout=5).json()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert proc.returncode == 0, out
    assert "blocked import" not in out
    return health


def test_serves_a_request_with_jax_and_reference_blocked(tmp_path):
    """Every port module imports, and the CLI serves one request on the CPU,
    in a process where importing jax or dnet_tpu raises."""
    health = _serve_one_guarded(tmp_path)
    assert "engine" not in health  # the single-sequence engine


def test_serves_a_batched_request_with_jax_and_reference_blocked(tmp_path):
    """The same with continuous batching: --batch-slots 2 over the paged
    pool, decoded through ragged paged attention; admission is capped at
    the slot count."""
    health = _serve_one_guarded(
        tmp_path, ["--batch-slots", "2"],
        {"DNET_KV_PAGED": "1", "DNET_KV_RAGGED": "1", "DNET_KV_BLOCK_TOKENS": "8"},
    )
    assert health["admission"]["capacity"] == 2
    assert health["engine"]["slots"] == 2 and health["engine"]["decode_steps"] >= 4
    assert health["engine"]["kv_blocks_used"] == 0


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_cuda_and_raises_without_it(tiny_llama_dir, no_cuda):
    from dnet_tpu_torch.core.engine import LocalEngine

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalEngine(tiny_llama_dir)
    assert LocalEngine(tiny_llama_dir, max_seq=16, param_dtype="float32", device="cpu").device.type == "cpu"


def test_cli_defaults_to_cuda_and_raises_without_it(tiny_llama_dir, no_cuda):
    from dnet_tpu_torch.cli.api import build_parser, main

    assert build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--model", str(tiny_llama_dir)])


def test_serves_a_ring_request_with_jax_and_reference_blocked(tmp_path, tiny_llama_dir):
    """Two shards and the API node of a ring, each a process where
    importing jax or dnet_tpu raises, serve one greedy request over gRPC."""
    from tests.test_torch_ring_serving import CHAT, CpuRing

    ring = CpuRing(tmp_path, guarded=True)
    try:
        ring.load(tiny_llama_dir)
        r = httpx.post(ring.base + "/v1/chat/completions", json=dict(CHAT, max_tokens=5), timeout=60)
        assert r.status_code == 200, r.text
        assert r.json()["usage"]["completion_tokens"] == 5
        assert ring.shard_health(1)["wire"]["frames_decoded"] == 5
    finally:
        outcomes = ring.stop()
    for code, out in outcomes:
        assert code == 0, out
        assert "blocked import" not in out


def test_shard_cli_defaults_to_cuda_and_raises_without_it(no_cuda):
    from dnet_tpu_torch.cli.shard import build_parser, main

    assert build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])
