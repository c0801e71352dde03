"""Random parameters with real model shapes, made on the device from a seed.

Counterpart of dnet_tpu/utils/random_init.py: the same window + edge params
the checkpoint loader produces, from a config alone, so full-width runs
need no weights on disk: Llama-3.2-1B's and gpt-oss-20b's published
shapes.  The values come from a `torch.Generator`, not `jax.random`: they
differ from the reference's for the same seed.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from dnet_tpu_torch.models.base import ModelConfig

LLAMA_3_2_1B_CONFIG = {
    "model_type": "llama",
    "vocab_size": 128256,
    "hidden_size": 2048,
    "intermediate_size": 8192,
    "num_hidden_layers": 16,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "head_dim": 64,
    "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0,
    "rope_scaling": {
        "rope_type": "llama3",
        "factor": 32.0,
        "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192,
    },
    "max_position_embeddings": 131072,
    "tie_word_embeddings": True,
}


# openai/gpt-oss-20b's published config.json (the fields the port reads)
GPT_OSS_20B_CONFIG = {
    "model_type": "gpt_oss",
    "vocab_size": 201088,
    "hidden_size": 2880,
    "intermediate_size": 2880,
    "num_hidden_layers": 24,
    "num_attention_heads": 64,
    "num_key_value_heads": 8,
    "head_dim": 64,
    "num_local_experts": 32,
    "num_experts_per_tok": 4,
    "sliding_window": 128,
    "layer_types": ["sliding_attention", "full_attention"] * 12,
    "rms_norm_eps": 1e-5,
    "rope_theta": 150000.0,
    "rope_scaling": {
        "rope_type": "yarn",
        "factor": 32.0,
        "beta_fast": 32.0,
        "beta_slow": 1.0,
        "truncate": False,
        "original_max_position_embeddings": 4096,
    },
    "max_position_embeddings": 131072,
    "tie_word_embeddings": False,
    "attention_bias": True,
    "swiglu_limit": 7.0,
}


def random_llama_params(
    cfg: ModelConfig,
    layers: Sequence[int],
    device: torch.device,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> Tuple[List[Dict[str, torch.Tensor]], Dict[str, Dict[str, torch.Tensor]]]:
    """(per-layer window params, edge params): N(0, 0.02) matrices and unit
    norms, drawn on `device`."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    H, KVH, Hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    V = cfg.vocab_size
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(*shape, scale=0.02):
        x = torch.randn(*shape, generator=gen, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    def ones(*shape):
        return torch.ones(*shape, device=device, dtype=dtype)

    window = [
        {
            "attn_norm": ones(D),
            "wq": w(D, H * Hd),
            "wk": w(D, KVH * Hd),
            "wv": w(D, KVH * Hd),
            "wo": w(H * Hd, D),
            "mlp_norm": ones(D),
            "w_gate": w(D, F),
            "w_up": w(D, F),
            "w_down": w(F, D),
        }
        for _ in layers
    ]
    edge = {"embed": {"weight": w(V, D)}, "final_norm": {"weight": ones(D)}}
    if not cfg.tie_word_embeddings:
        edge["lm_head"] = {"weight": w(D, V)}
    return window, edge


def random_gpt_oss_params(
    cfg: ModelConfig,
    layers: Sequence[int],
    device: torch.device,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> Tuple[List[Dict[str, torch.Tensor]], Dict[str, Dict[str, torch.Tensor]]]:
    """(per-layer window params in layer order, edge params) of a gpt_oss
    model: N(0, 0.02) matrices and experts, N(0, 0.02) biases, N(0, 0.5)
    sink logits and unit norms, drawn on `device` one tensor at a time (a
    full-width layer's experts are 0.8 G values)."""
    D, F, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts
    H, KVH, Hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    V = cfg.vocab_size
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(*shape, scale=0.02):
        x = torch.randn(*shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(scale).to(dtype)

    def ones(*shape):
        return torch.ones(*shape, device=device, dtype=dtype)

    window = [
        {
            "attn_norm": ones(D),
            "wq": w(D, H * Hd), "bq": w(H * Hd),
            "wk": w(D, KVH * Hd), "bk": w(KVH * Hd),
            "wv": w(D, KVH * Hd), "bv": w(KVH * Hd),
            "wo": w(H * Hd, D), "bo": w(D),
            "sinks": w(H, scale=0.5),
            "mlp_norm": ones(D),
            "router_w": w(D, E), "router_b": w(E),
            "gate_up": w(E, D, 2 * F), "gate_up_b": w(E, 2 * F),
            "down": w(E, F, D), "down_b": w(E, D),
        }
        for _ in layers
    ]
    edge = {"embed": {"weight": w(V, D)}, "final_norm": {"weight": ones(D)}, "lm_head": {"weight": w(D, V)}}
    return window, edge
