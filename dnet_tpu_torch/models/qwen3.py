"""Qwen3-family model.

Counterpart of dnet_tpu/models/qwen3.py: the llama decoder with per-head
RMSNorm of q and k over head_dim before RoPE (the `_qk_transform` hook) and
a head_dim read from the config, decoupled from hidden_size / heads
(`ModelConfig.from_hf`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from dnet_tpu_torch.models.llama import LlamaRingModel
from dnet_tpu_torch.ops.norms import rms_norm


class Qwen3RingModel(LlamaRingModel):
    model_type = "qwen3"

    def _qk_transform(self, p: dict, q: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        eps = self.config.rms_norm_eps
        return rms_norm(q, p["q_norm"], eps), rms_norm(k, p["k_norm"], eps)

    def map_layer(self, raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        params = super().map_layer(raw)
        params["q_norm"] = raw["self_attn.q_norm.weight"]
        params["k_norm"] = raw["self_attn.k_norm.weight"]
        return params
