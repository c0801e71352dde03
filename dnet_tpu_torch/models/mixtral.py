"""Mixtral-family model: llama attention + a top-k sparse MoE FFN.

Counterpart of dnet_tpu/models/mixtral.py on one device (or over
sequence-parallel ranks, which only the attention half sees).  The
attention half is llama's.  Every layer's FFN is a sparse MoE: the router
scores E experts in f32, the weights are a softmax over ALL logits, then
the top k, renormalized (transformers' MixtralSparseMoeBlock), and each
expert is a SwiGLU (w1 = gate, w3 = up, w2 = down) stacked on a leading
expert axis.  No shared experts.  The experts run through ops/moe.py
(`swiglu_expert_closures`, `moe_apply`): dense by default (exact), capacity
dispatch when DNET_COMPUTE_MOE_IMPL says so.
"""

from __future__ import annotations

from typing import Dict

import torch

from dnet_tpu_torch.models.llama import LlamaRingModel
from dnet_tpu_torch.ops.moe import moe_apply, resolve_moe_impl, swiglu_expert_closures
from dnet_tpu_torch.ops.norms import rms_norm


class MixtralRingModel(LlamaRingModel):
    model_type = "mixtral"
    # the weights a weight quantizer would take (the router gate_w stays
    # f32: routing decisions are precision-sensitive); the reference's set
    quant_keys = frozenset({"wq", "wk", "wv", "wo", "e_gate", "e_up", "e_down"})
    # renormalize the kept top-k weights: always for mixtral, read from the
    # config for qwen3_moe
    norm_topk_prob = True

    def __init__(self, config, layers, device):
        super().__init__(config, layers, device)
        resolve_moe_impl(self.moe_impl, 1, max(config.num_local_experts, 1))  # fail fast on a typo

    def _mlp_block(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        h = rms_norm(x, p["mlp_norm"], self.config.rms_norm_eps)
        flat = h.reshape(B * T, D)
        # softmax over every expert's logit first, then top-k, then renormalize
        scores = torch.softmax(flat.float() @ p["gate_w"].float(), dim=-1)  # [N, E] f32
        k = self.config.num_experts_per_tok
        top_w, top_idx = torch.topk(scores, k, dim=-1)
        if self.norm_topk_prob:
            top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        effn, dense, E = swiglu_expert_closures(p, flat, top_idx, top_w)
        routed = moe_apply(self.moe_impl, flat, top_idx, top_w, effn, E, self.moe_capacity_factor, k, dense)
        return x + routed.to(flat.dtype).reshape(B, T, D)

    def map_layer(self, raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        def t(name: str) -> torch.Tensor:
            return raw[name].T.contiguous()  # HF [out, in] -> (in, out)

        E = self.config.num_local_experts
        p = {
            "attn_norm": raw["input_layernorm.weight"],
            "wq": t("self_attn.q_proj.weight"),
            "wk": t("self_attn.k_proj.weight"),
            "wv": t("self_attn.v_proj.weight"),
            "wo": t("self_attn.o_proj.weight"),
            "mlp_norm": raw["post_attention_layernorm.weight"],
            "gate_w": t("block_sparse_moe.gate.weight"),  # [D, E] router
        }
        # experts stacked on a leading E axis, (in, out)-oriented
        for name, hf in (("e_gate", "w1"), ("e_up", "w3"), ("e_down", "w2")):
            p[name] = torch.stack([t(f"block_sparse_moe.experts.{e}.{hf}.weight") for e in range(E)])
        return p
