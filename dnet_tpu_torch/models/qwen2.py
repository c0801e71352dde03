"""Qwen2 / Qwen2.5-family model.

Counterpart of dnet_tpu/models/qwen2.py: the llama decoder with biased
q/k/v projections (o_proj and the MLP stay bias-free), which llama's
content-keyed `map_layer` already maps, so everything is inherited; the
subclass claims the `qwen2` model_type in the registry.
"""

from __future__ import annotations

from dnet_tpu_torch.models.llama import LlamaRingModel


class Qwen2RingModel(LlamaRingModel):
    model_type = "qwen2"
