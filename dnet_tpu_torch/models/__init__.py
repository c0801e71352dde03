"""Model registry: HF `model_type` string -> RingModel subclass.

Counterpart of dnet_tpu/models/__init__.py; the port registers the llama,
gpt_oss and deepseek_v2 families so far.
"""

from __future__ import annotations

from typing import Type

from dnet_tpu_torch.models.base import ModelConfig, RingModel
from dnet_tpu_torch.models.deepseek_v2 import DeepseekV2RingModel
from dnet_tpu_torch.models.gpt_oss import GptOssRingModel
from dnet_tpu_torch.models.llama import LlamaRingModel

_REGISTRY = {cls.model_type: cls for cls in (LlamaRingModel, GptOssRingModel, DeepseekV2RingModel)}


def get_ring_model_cls(model_type: str) -> Type[RingModel]:
    try:
        return _REGISTRY[model_type]
    except KeyError:
        raise ValueError(f"unsupported model_type: {model_type!r}") from None


__all__ = ["ModelConfig", "RingModel", "get_ring_model_cls"]
