"""Random parameters with real model shapes, made on the device from a seed.

Counterpart of dnet_tpu/utils/random_init.py: the same window + edge params
the checkpoint loader produces, from a config alone, so full-width runs
need no weights on disk.  The values come from a `torch.Generator`, not
`jax.random`: they differ from the reference's for the same seed.
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
