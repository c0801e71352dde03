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

    import os
    from dnet_tpu_torch.utils.checkpoint import save_checkpoint
    rng = np.random.default_rng(0)
    cfg = {"model_type": "llama", "vocab_size": 261, "hidden_size": 32,
           "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 8, "tie_word_embeddings": False}
    w = lambda *s: rng.normal(0, 0.05, size=s).astype(np.float32)
    t = {"model.embed_tokens.weight": w(261, 32), "model.norm.weight": np.ones(32, np.float32),
         "lm_head.weight": w(261, 32)}
    layer = [("input_layernorm.weight", (32,)), ("post_attention_layernorm.weight", (32,)),
             ("self_attn.q_proj.weight", (32, 32)), ("self_attn.k_proj.weight", (16, 32)),
             ("self_attn.v_proj.weight", (16, 32)), ("self_attn.o_proj.weight", (32, 32))]
    if os.environ.get("GUARDED_MODEL") == "gpt_oss":
        # 2 layers (one sliding, one full), a ring of 4, 4 experts top-2, sinks, YaRN
        cfg.update(model_type="gpt_oss", intermediate_size=24, num_local_experts=4,
                   num_experts_per_tok=2, sliding_window=4,
                   layer_types=["sliding_attention", "full_attention"],
                   rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                                 "beta_slow": 1.0, "truncate": False,
                                 "original_max_position_embeddings": 4096})
        layer += [("self_attn.q_proj.bias", (32,)), ("self_attn.k_proj.bias", (16,)),
                  ("self_attn.v_proj.bias", (16,)), ("self_attn.o_proj.bias", (32,)),
                  ("self_attn.sinks", (4,)), ("mlp.router.weight", (4, 32)),
                  ("mlp.router.bias", (4,)), ("mlp.experts.gate_up_proj", (4, 32, 48)),
                  ("mlp.experts.gate_up_proj_bias", (4, 48)), ("mlp.experts.down_proj", (4, 24, 32)),
                  ("mlp.experts.down_proj_bias", (4, 32))]
    else:
        layer += [("mlp.gate_proj.weight", (64, 32)), ("mlp.up_proj.weight", (64, 32)),
                  ("mlp.down_proj.weight", (32, 64))]
    layers = [layer, layer]
    if os.environ.get("GUARDED_MODEL") == "deepseek_v2":
        # MLA (q/k head dim 8 + 4, v head dim 8, latent 16), layer 0 dense,
        # layer 1 MoE: 4 routed experts top-2 + 1 shared
        cfg.update(model_type="deepseek_v2", num_key_value_heads=4, q_lora_rank=None, kv_lora_rank=16,
                   qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, n_routed_experts=4,
                   n_shared_experts=1, num_experts_per_tok=2, moe_intermediate_size=16,
                   first_k_dense_replace=1, topk_method="greedy")
        attn = [("input_layernorm.weight", (32,)), ("post_attention_layernorm.weight", (32,)),
                ("self_attn.q_proj.weight", (4 * 12, 32)), ("self_attn.kv_a_proj_with_mqa.weight", (20, 32)),
                ("self_attn.kv_a_layernorm.weight", (16,)), ("self_attn.kv_b_proj.weight", (4 * 16, 16)),
                ("self_attn.o_proj.weight", (32, 4 * 8))]
        dense = [("mlp.gate_proj.weight", (64, 32)), ("mlp.up_proj.weight", (64, 32)),
                 ("mlp.down_proj.weight", (32, 64))]
        experts = [(f"mlp.experts.{e}.{n}", s) for e in range(4)
                   for n, s in (("gate_proj.weight", (16, 32)), ("up_proj.weight", (16, 32)),
                                ("down_proj.weight", (32, 16)))]
        shared = [("mlp.gate.weight", (4, 32)), ("mlp.shared_experts.gate_proj.weight", (16, 32)),
                  ("mlp.shared_experts.up_proj.weight", (16, 32)), ("mlp.shared_experts.down_proj.weight", (32, 16))]
        layers = [attn + dense, attn + experts + shared]
    if os.environ.get("GUARDED_MODEL") == "qwen3_moe":
        # q/k norms, layer 0 dense (mlp_only_layers), layer 1 MoE: 4 experts
        # top-2, norm_topk_prob absent (False)
        cfg.update(model_type="qwen3_moe", num_experts=4, num_experts_per_tok=2, moe_intermediate_size=16,
                   mlp_only_layers=[0], decoder_sparse_step=1)
        attn = layer[:6] + [("self_attn.q_norm.weight", (8,)), ("self_attn.k_norm.weight", (8,))]
        experts = [("mlp.gate.weight", (4, 32))] + [
            (f"mlp.experts.{e}.{n}", s) for e in range(4)
            for n, s in (("gate_proj.weight", (16, 32)), ("up_proj.weight", (16, 32)), ("down_proj.weight", (32, 16)))]
        layers = [attn + layer[6:], attn + experts]
    for i, names in enumerate(layers):
        for n, s in names:
            t[f"model.layers.{i}." + n] = w(*s)
    save_checkpoint(sys.argv[1], cfg, t)

    from dnet_tpu_torch.cli.api import main
    # GUARDED_VARIANT ":int8": the catalog's weight-only variant of the same checkpoint
    sys.exit(main(["--model", sys.argv[1] + os.environ.get("GUARDED_VARIANT", ""), "--device", "cpu",
                   "--host", "127.0.0.1",
                   "--http-port", sys.argv[2], "--max-seq-len", "64",
                   "--param-dtype", "float32", *sys.argv[3:]]))
    """
)


def test_no_jax_or_reference_imports_in_source():
    files = sorted(PORT_PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for module in ("models/gpt_oss.py", "models/deepseek_v2.py", "models/segments.py", "models/qwen2.py",
                   "models/qwen3.py", "models/mixtral.py", "models/qwen3_moe.py", "ops/moe.py", "ops/rope.py",
                   "ops/attention.py", "core/kvcache.py", "config.py", "ops/quant.py", "api/catalog.py"):
        assert PORT_PKG / module in files
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


def _serve_one_guarded(tmp_path, extra_args=(), extra_env=None, model="m") -> dict:
    """Run the CLI in a process where importing jax or dnet_tpu raises,
    serve one greedy chat request for `model`, and return /health as it
    was then."""
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
            json={"model": model, "messages": [{"role": "user", "content": "hi"}],
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
    assert "slots" not in health["engine"]  # the single-sequence engine
    assert health["engine"]["kv_quant_bits"] == 0


def test_serves_a_quantized_request_with_jax_and_reference_blocked(tmp_path):
    """The same guarded serve with DNET_KV_BITS=8: the single-sequence
    engine gets an int8 cache."""
    health = _serve_one_guarded(tmp_path, extra_env={"DNET_KV_BITS": "8"})
    assert "slots" not in health["engine"]
    assert health["engine"]["kv_quant_bits"] == 8
    # 2 layers x 64 slots x 2 KV heads x (8 + 8 code bytes + 2 x 4 scale bytes)
    assert health["engine"]["kv_bytes"] == 2 * 64 * 2 * (8 + 8 + 8)


def test_serves_an_int8_weight_request_with_jax_and_reference_blocked(tmp_path):
    """The guarded serve of the checkpoint's `:int8` variant: every layer
    matrix and the LM head as int8 codes with f32 scales (their groups span
    the whole 32- / 64-row in axis)."""
    health = _serve_one_guarded(tmp_path, extra_env={"GUARDED_VARIANT": ":int8"}, model=str(tmp_path / "ckpt:int8"))
    assert health["engine"]["weight_quant_bits"] == 8
    # per layer: 2 f32 norms (256 B); q/k/v/o codes 32 x (32 + 16 + 16 + 32) + f32 scales 4 x (32 + 16 + 16 + 32);
    # gate/up/down codes 3 x 2048 + scales 4 x (64 + 64 + 32); the f32 embedding, the final norm, and the
    # LM head's codes 32 x 261 + scales 4 x 261
    layer = 256 + 32 * 96 + 4 * 96 + 3 * 2048 + 4 * 160
    assert health["engine"]["weight_bytes"] == 2 * layer + 261 * 32 * 4 + 32 * 4 + 261 * 32 + 261 * 4


def test_serves_a_gpt_oss_request_with_jax_and_reference_blocked(tmp_path):
    """The guarded serve on a gpt_oss checkpoint: the prompt (~20 tokens
    under the chat template) wraps the 4-row ring, and /health counts the
    paired cache (1 sliding layer x 4 rows + 1 full layer x 64 rows)."""
    health = _serve_one_guarded(tmp_path, extra_env={"GUARDED_MODEL": "gpt_oss"})
    assert "slots" not in health["engine"]
    # k and v, 2 KV heads x head dim 8, f32
    assert health["engine"]["kv_bytes"] == (4 + 64) * 2 * 2 * 8 * 4


def test_serves_a_deepseek_v2_request_with_jax_and_reference_blocked(tmp_path):
    """The guarded serve on a deepseek_v2 checkpoint (MLA, a dense layer and
    a MoE layer): /health counts the asymmetric cache."""
    health = _serve_one_guarded(tmp_path, extra_env={"GUARDED_MODEL": "deepseek_v2"})
    assert "slots" not in health["engine"]
    # 2 layers x 64 slots x 4 KV heads x (k 12 + v 8), f32
    assert health["engine"]["kv_bytes"] == 2 * 64 * 4 * (12 + 8) * 4


def test_serves_a_qwen3_moe_request_with_jax_and_reference_blocked(tmp_path):
    """The guarded serve on a mixed qwen3_moe checkpoint (q/k norms, a
    dense layer and a MoE layer)."""
    health = _serve_one_guarded(tmp_path, extra_env={"GUARDED_MODEL": "qwen3_moe"})
    assert "slots" not in health["engine"]
    # 2 layers x 64 slots x 2 KV heads x (k 8 + v 8), f32
    assert health["engine"]["kv_bytes"] == 2 * 64 * 2 * 16 * 4


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


def test_serves_dense_batched_slots_with_jax_and_reference_blocked(tmp_path):
    """--batch-slots 2 without DNET_KV_PAGED: dense slots, here with an
    int4 cache."""
    health = _serve_one_guarded(tmp_path, ["--batch-slots", "2"], {"DNET_KV_BITS": "4"})
    engine = health["engine"]
    assert engine["slots"] == 2 and engine["kv_mode"] == "dense" and engine["kv_quant_bits"] == 4
    assert engine["decode_steps"] >= 4 and engine["active"] == 0


@pytest.mark.parametrize("slots", [1, 2])
def test_serves_speculation_and_prefix_cache_with_jax_and_reference_blocked(tmp_path, slots):
    """The guarded serve with DNET_API_SPEC_LOOKAHEAD=3 and
    DNET_API_PREFIX_CACHE=2, single sequence and on dense slots: the greedy
    request runs verify blocks, and the prompt's snapshot is stored."""
    args = ["--batch-slots", "2"] if slots == 2 else []
    health = _serve_one_guarded(tmp_path, args, {"DNET_API_SPEC_LOOKAHEAD": "3", "DNET_API_PREFIX_CACHE": "2"})
    engine = health["engine"]
    assert engine["spec_lookahead"] == 3 and engine["spec_blocks"] >= 1
    assert engine["prefix_cache"]["stores"] == 1


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
