"""Random parameters with real model shapes, made on the device from a seed.

Counterpart of dnet_tpu/utils/random_init.py: the same window + edge params
the checkpoint loader produces, from a config alone, so full-width runs
need no weights on disk: Llama-3.2-1B's, Llama-3.3-70B-Instruct's, gpt-oss-20b's,
DeepSeek-V2-Lite-Chat's, Qwen3-30B-A3B's and Qwen3-235B-A22B's published
shapes, and the heads of Qwen2.5-7B, Qwen3-4B and Mixtral-8x7B.  The values come from a `torch.Generator`, not `jax.random`: they
differ from the reference's for the same seed.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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


# meta-llama/Llama-3.3-70B-Instruct's published config.json (the fields the
# port reads): 80 layers, 64 query heads over 8 KV heads at head dim 128,
# untied, llama3 rope scaling with factor 8
LLAMA_3_3_70B_CONFIG = {
    "model_type": "llama",
    "vocab_size": 128256,
    "hidden_size": 8192,
    "intermediate_size": 28672,
    "num_hidden_layers": 80,
    "num_attention_heads": 64,
    "num_key_value_heads": 8,
    "head_dim": 128,
    "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0,
    "rope_scaling": {
        "rope_type": "llama3",
        "factor": 8.0,
        "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192,
    },
    "max_position_embeddings": 131072,
    "tie_word_embeddings": False,
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


# deepseek-ai/DeepSeek-V2-Lite-Chat's published config.json (the fields the
# port reads): MLA with no q LoRA, 64 routed experts top-6 + 2 shared, layer
# 0 dense, YaRN factor 40 with mscale = mscale_all_dim = 0.707
DEEPSEEK_V2_LITE_CONFIG = {
    "model_type": "deepseek_v2",
    "vocab_size": 102400,
    "hidden_size": 2048,
    "intermediate_size": 10944,
    "moe_intermediate_size": 1408,
    "num_hidden_layers": 27,
    "num_attention_heads": 16,
    "num_key_value_heads": 16,
    "q_lora_rank": None,
    "kv_lora_rank": 512,
    "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64,
    "v_head_dim": 128,
    "n_routed_experts": 64,
    "n_shared_experts": 2,
    "num_experts_per_tok": 6,
    "first_k_dense_replace": 1,
    "moe_layer_freq": 1,
    "topk_method": "greedy",
    "n_group": 1,
    "topk_group": 1,
    "routed_scaling_factor": 1.0,
    "norm_topk_prob": False,
    "scoring_func": "softmax",
    "rms_norm_eps": 1e-6,
    "rope_theta": 10000,
    "rope_scaling": {
        "type": "yarn",
        "factor": 40,
        "mscale": 0.707,
        "mscale_all_dim": 0.707,
        "original_max_position_embeddings": 4096,
        "beta_fast": 32,
        "beta_slow": 1,
    },
    "max_position_embeddings": 163840,
    "tie_word_embeddings": False,
    "attention_bias": False,
    "hidden_act": "silu",
    "bos_token_id": 100000,
    "eos_token_id": 100001,
}


# Qwen/Qwen3-30B-A3B's and Qwen/Qwen3-235B-A22B's published config.json (the
# fields the port reads): every layer MoE, 128 experts top-8 renormalized
QWEN3_30B_A3B_CONFIG = {
    "model_type": "qwen3_moe",
    "vocab_size": 151936,
    "hidden_size": 2048,
    "intermediate_size": 6144,
    "moe_intermediate_size": 768,
    "num_hidden_layers": 48,
    "num_attention_heads": 32,
    "num_key_value_heads": 4,
    "head_dim": 128,
    "num_experts": 128,
    "num_experts_per_tok": 8,
    "norm_topk_prob": True,
    "decoder_sparse_step": 1,
    "mlp_only_layers": [],
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "rope_scaling": None,
    "max_position_embeddings": 40960,
    "tie_word_embeddings": False,
    "attention_bias": False,
}
QWEN3_235B_A22B_CONFIG = {
    **QWEN3_30B_A3B_CONFIG,
    "hidden_size": 4096,
    "intermediate_size": 12288,
    "moe_intermediate_size": 1536,
    "num_hidden_layers": 94,
    "num_attention_heads": 64,
}
# the attention widths of Qwen/Qwen2.5-7B (28 / 4 heads, qkv biases),
# Qwen/Qwen3-4B (32 / 8, q/k norms) and mistralai/Mixtral-8x7B-v0.1 (32 / 8,
# 8 experts top-2) from their published config.json
QWEN2_5_7B_CONFIG = {
    "model_type": "qwen2", "vocab_size": 152064, "hidden_size": 3584, "intermediate_size": 18944,
    "num_hidden_layers": 28, "num_attention_heads": 28, "num_key_value_heads": 4, "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0, "max_position_embeddings": 32768, "tie_word_embeddings": False,
}
QWEN3_4B_CONFIG = {
    "model_type": "qwen3", "vocab_size": 151936, "hidden_size": 2560, "intermediate_size": 9728,
    "num_hidden_layers": 36, "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "rms_norm_eps": 1e-6, "rope_theta": 1000000.0, "max_position_embeddings": 40960, "tie_word_embeddings": True,
}
MIXTRAL_8X7B_CONFIG = {
    "model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8, "num_local_experts": 8,
    "num_experts_per_tok": 2, "rms_norm_eps": 1e-5, "rope_theta": 1000000.0, "max_position_embeddings": 32768,
    "tie_word_embeddings": False,
}


def random_llama_layers(
    cfg: ModelConfig,
    layers: Sequence[int],
    device: torch.device,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    gen: Optional[torch.Generator] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """A llama model's per-layer window params, one layer at a time: N(0,
    0.02) matrices and unit norms, drawn on `device` (from `gen` when given,
    else a generator seeded with `seed`).  An engine that takes the layers
    as they come (LocalEngine.from_params with weight_quant_bits) quantizes
    each one before the next is drawn, so a model that fits the device only
    quantized is never whole in full precision."""
    D, F = cfg.hidden_size, cfg.intermediate_size
    H, KVH, Hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    gen = gen or torch.Generator(device=device).manual_seed(seed)
    w, ones = _drawers(gen, device, dtype)
    for _ in layers:
        yield {
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


def random_llama_edge(
    cfg: ModelConfig,
    device: torch.device,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    gen: Optional[torch.Generator] = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """A llama model's edge params (the embedding, the final norm and, when
    untied, the LM head), drawn as random_llama_layers draws."""
    D, V = cfg.hidden_size, cfg.vocab_size
    w, ones = _drawers(gen or torch.Generator(device=device).manual_seed(seed), device, dtype)
    edge = {"embed": {"weight": w(V, D)}, "final_norm": {"weight": ones(D)}}
    if not cfg.tie_word_embeddings:
        edge["lm_head"] = {"weight": w(D, V)}
    return edge


def _drawers(gen: torch.Generator, device: torch.device, dtype: torch.dtype):
    def w(*shape, scale=0.02):
        x = torch.randn(*shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(scale).to(dtype)

    def ones(*shape):
        return torch.ones(*shape, device=device, dtype=dtype)

    return w, ones


def random_llama_params(
    cfg: ModelConfig,
    layers: Sequence[int],
    device: torch.device,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> Tuple[List[Dict[str, torch.Tensor]], Dict[str, Dict[str, torch.Tensor]]]:
    """(per-layer window params, edge params): N(0, 0.02) matrices and unit
    norms, drawn on `device`, the layers first."""
    gen = torch.Generator(device=device).manual_seed(seed)
    window = list(random_llama_layers(cfg, layers, device, dtype, gen=gen))
    return window, random_llama_edge(cfg, device, dtype, gen=gen)


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


def random_deepseek_v2_params(
    cfg: ModelConfig,
    layers: Sequence[int],
    device: torch.device,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> Tuple[List[Dict[str, torch.Tensor]], Dict[str, Dict[str, torch.Tensor]]]:
    """(per-layer window params in layer order, edge params) of a
    deepseek_v2 model: N(0, 0.02) matrices and experts and unit norms,
    drawn on `device` one tensor at a time (a full-width MoE layer's experts
    are 0.55 G values).  Layers below first_k_dense_replace get the dense
    MLP, the others the router, the stacked experts and the shared ones."""
    x = cfg.extra
    D, F, V, H = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_attention_heads
    nope, rope_d, vd = x["qk_nope_head_dim"], x["qk_rope_head_dim"], x["v_head_dim"]
    kv_rank, q_rank = x["kv_lora_rank"], x.get("q_lora_rank")
    E, MF = x["n_routed_experts"], x["moe_intermediate_size"]
    SF = MF * x["n_shared_experts"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(*shape, scale=0.02):
        t = torch.randn(*shape, generator=gen, device=device, dtype=torch.float32)
        return t.mul_(scale).to(dtype)

    def ones(*shape):
        return torch.ones(*shape, device=device, dtype=dtype)

    def layer(a: int) -> Dict[str, torch.Tensor]:
        p = {"attn_norm": ones(D), "mlp_norm": ones(D)}
        if q_rank is None:
            p["wq"] = w(D, H * (nope + rope_d))
        else:
            p.update(wq_a=w(D, q_rank), q_a_norm=ones(q_rank), wq_b=w(q_rank, H * (nope + rope_d)))
        p.update(wkv_a=w(D, kv_rank + rope_d), kv_a_norm=ones(kv_rank), wkv_b=w(kv_rank, H * (nope + vd)),
                 wo=w(H * vd, D))
        if E and a >= x.get("first_k_dense_replace", 0):
            p.update(gate_w=w(D, E), e_gate=w(E, D, MF), e_up=w(E, D, MF), e_down=w(E, MF, D),
                     s_gate=w(D, SF), s_up=w(D, SF), s_down=w(SF, D))
        else:
            p.update(w_gate=w(D, F), w_up=w(D, F), w_down=w(F, D))
        return p

    window = [layer(a) for a in layers]
    edge = {"embed": {"weight": w(V, D)}, "final_norm": {"weight": ones(D)}}
    if not cfg.tie_word_embeddings:
        edge["lm_head"] = {"weight": w(D, V)}
    return window, edge


def random_qwen_params(
    cfg: ModelConfig,
    layers: Sequence[int],
    device: torch.device,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> Tuple[List[Dict[str, torch.Tensor]], Dict[str, Dict[str, torch.Tensor]]]:
    """(per-layer window params in layer order, edge params) of a qwen2,
    qwen3, mixtral or qwen3_moe model: N(0, 0.02) matrices, experts and qkv
    biases (qwen2) and unit norms (q/k norms for qwen3 and qwen3_moe), drawn
    on `device` one tensor at a time (a full-width Qwen3-235B-A22B layer's
    experts are 2.4 G values).  Mixtral's layers and qwen3_moe's MoE layers
    (`moe_layer_kinds`) get the router and stacked experts (of
    moe_intermediate_size for qwen3_moe), the others the dense SwiGLU."""
    from dnet_tpu_torch.models.qwen3_moe import moe_layer_kinds

    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, KVH, Hd, E = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.num_local_experts
    family = cfg.model_type
    MF = cfg.extra.get("moe_intermediate_size", F)
    if family == "qwen3_moe":
        kinds = moe_layer_kinds(cfg.extra, cfg.num_hidden_layers)
    else:
        kinds = [family == "mixtral"] * cfg.num_hidden_layers
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(*shape, scale=0.02):
        t = torch.randn(*shape, generator=gen, device=device, dtype=torch.float32)
        return t.mul_(scale).to(dtype)

    def ones(*shape):
        return torch.ones(*shape, device=device, dtype=dtype)

    def layer(a: int) -> Dict[str, torch.Tensor]:
        p = {"attn_norm": ones(D), "wq": w(D, H * Hd), "wk": w(D, KVH * Hd), "wv": w(D, KVH * Hd),
             "wo": w(H * Hd, D), "mlp_norm": ones(D)}
        if family == "qwen2":
            p.update(bq=w(H * Hd), bk=w(KVH * Hd), bv=w(KVH * Hd))
        if family in ("qwen3", "qwen3_moe"):
            p.update(q_norm=ones(Hd), k_norm=ones(Hd))
        if kinds[a]:
            p.update(gate_w=w(D, E), e_gate=w(E, D, MF), e_up=w(E, D, MF), e_down=w(E, MF, D))
        else:
            p.update(w_gate=w(D, F), w_up=w(D, F), w_down=w(F, D))
        return p

    window = [layer(a) for a in layers]
    edge = {"embed": {"weight": w(V, D)}, "final_norm": {"weight": ones(D)}}
    if not cfg.tie_word_embeddings:
        edge["lm_head"] = {"weight": w(D, V)}
    return window, edge
