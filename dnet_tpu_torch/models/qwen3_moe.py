"""Qwen3-MoE-family model (Qwen3-30B-A3B / Qwen3-235B-A22B class).

Counterpart of dnet_tpu/models/qwen3_moe.py: Qwen3's attention (per-head
q/k RMSNorm before RoPE) with Mixtral's sparse MoE block, whose
`norm_topk_prob` comes from the config and defaults to False when absent
(transformers' Qwen3MoeConfig; mixtral always renormalizes).  The HF
weight names are qwen3_moe's own (`mlp.gate`, `mlp.experts.{e}.gate_proj`
...).

Mixed dense/MoE layouts (`mlp_only_layers`, `decoder_sparse_step`), both
dense-prefix and interleaved, need no stacking of their own here: the port
loops over per-layer param dicts, and each layer picks its MLP by its own
params, as the reference's `_mlp_block` does on `"e_gate" in p`.  Where
the reference stacks {"dense", "moe"} segments and runs two-segment or
`lax.cond` scans, the window stays one list in layer order; so a streamed
layer (weight streaming) is the base class's one-element window, where the
reference's `wrap_offload_layer` picks the layer's segment.

The paged attend hook therefore threads through mixed stacks too, so
`supports_paged_attend` is inherited (True) for every layout.  The
reference's mixed scans do not carry it, and its batched server serves
them through its dense-gather paged decode instead; both answer a greedy
request with the same text.
"""

from __future__ import annotations

from typing import Dict

import torch

from dnet_tpu_torch.models.llama import LlamaRingModel
from dnet_tpu_torch.models.mixtral import MixtralRingModel
from dnet_tpu_torch.models.qwen3 import Qwen3RingModel


def moe_layer_kinds(extra: dict, n_layers: int) -> list:
    """Whether each layer (in global order) is a MoE layer: not in
    `mlp_only_layers`, and on the `decoder_sparse_step` stride."""
    mlp_only = set(extra.get("mlp_only_layers") or [])
    step = extra.get("decoder_sparse_step", 1)
    return [a not in mlp_only and (step <= 1 or (a + 1) % step == 0) for a in range(n_layers)]


class Qwen3MoeRingModel(MixtralRingModel, Qwen3RingModel):
    """MRO: Mixtral's sparse MoE block and Qwen3's q/k norms over the shared
    llama decoder."""

    model_type = "qwen3_moe"
    # mixtral's expert keys plus the dense SwiGLU keys mixed layouts carry
    quant_keys = MixtralRingModel.quant_keys | {"w_gate", "w_up", "w_down"}

    def __init__(self, config, layers, device):
        super().__init__(config, layers, device)
        self.norm_topk_prob = bool(config.extra.get("norm_topk_prob", False))
        self._kinds = moe_layer_kinds(config.extra, config.num_hidden_layers)

    def is_moe_layer(self, abs_layer: int) -> bool:
        return self._kinds[abs_layer]

    def _mlp_block(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        if "e_gate" in p:
            return MixtralRingModel._mlp_block(self, p, x)
        return LlamaRingModel._mlp_block(self, p, x)

    def map_layer(self, raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        def t(name: str) -> torch.Tensor:
            return raw[name].T.contiguous()  # HF [out, in] -> (in, out)

        p = {
            "attn_norm": raw["input_layernorm.weight"],
            "wq": t("self_attn.q_proj.weight"),
            "wk": t("self_attn.k_proj.weight"),
            "wv": t("self_attn.v_proj.weight"),
            "wo": t("self_attn.o_proj.weight"),
            "q_norm": raw["self_attn.q_norm.weight"],
            "k_norm": raw["self_attn.k_norm.weight"],
            "mlp_norm": raw["post_attention_layernorm.weight"],
        }
        if "mlp.gate.weight" in raw:  # MoE layer
            E = self.config.num_local_experts
            p["gate_w"] = t("mlp.gate.weight")  # [D, E] router
            for name, hf in (("e_gate", "gate_proj"), ("e_up", "up_proj"), ("e_down", "down_proj")):
                p[name] = torch.stack([t(f"mlp.experts.{e}.{hf}.weight") for e in range(E)])
        else:  # an mlp_only / off-stride layer: llama's SwiGLU
            p["w_gate"] = t("mlp.gate_proj.weight")
            p["w_up"] = t("mlp.up_proj.weight")
            p["w_down"] = t("mlp.down_proj.weight")
        return p
