"""Model registry: HF `model_type` string -> RingModel subclass.

Counterpart of dnet_tpu/models/__init__.py; the port registers all seven
families the reference does: llama, qwen2, qwen3, mixtral, qwen3_moe,
gpt_oss and deepseek_v2.
"""

from __future__ import annotations

from typing import Type

from dnet_tpu_torch.models.base import ModelConfig, RingModel
from dnet_tpu_torch.models.deepseek_v2 import DeepseekV2RingModel
from dnet_tpu_torch.models.gpt_oss import GptOssRingModel
from dnet_tpu_torch.models.llama import LlamaRingModel
from dnet_tpu_torch.models.mixtral import MixtralRingModel
from dnet_tpu_torch.models.qwen2 import Qwen2RingModel
from dnet_tpu_torch.models.qwen3 import Qwen3RingModel
from dnet_tpu_torch.models.qwen3_moe import Qwen3MoeRingModel

_REGISTRY = {
    cls.model_type: cls
    for cls in (LlamaRingModel, Qwen2RingModel, Qwen3RingModel, MixtralRingModel, Qwen3MoeRingModel,
                GptOssRingModel, DeepseekV2RingModel)
}


def get_ring_model_cls(model_type: str) -> Type[RingModel]:
    try:
        return _REGISTRY[model_type]
    except KeyError:
        raise ValueError(f"unsupported model_type: {model_type!r}") from None


__all__ = ["ModelConfig", "RingModel", "get_ring_model_cls"]
