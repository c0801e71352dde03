"""Layer-wise ring model abstraction.

Counterpart of dnet_tpu/models/base.py: a model over a set of assigned
absolute layers with the edge ops (embed / normalize / lm_project) and the
HF weight mapping.  Instances hold no parameters; params are passed to
every call.  Where the reference stacks layers on a leading axis for one
`lax.scan`, the port keeps a list of per-layer param dicts and loops.

Parameter layout (tensors on the engine's device):
  window params: [ {per-layer name: tensor}, ... ]  one dict per layer
  edge params:   {"embed": {"weight"}, "final_norm": {"weight"},
                  "lm_head": {"weight" [hidden, vocab]}  (untied only)}
Matrices are (in, out)-oriented, as in the reference, so the hot path is
`x @ W`.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from dnet_tpu_torch.core.kvcache import KVConfig, init_cache


@dataclass
class ModelConfig:
    """Normalized HF config (config.json) subset."""

    model_type: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 8192

    @classmethod
    def from_hf(cls, d: Dict[str, Any]) -> "ModelConfig":
        heads = d["num_attention_heads"]
        head_dim = d.get("head_dim") or d["hidden_size"] // heads
        return cls(
            model_type=d["model_type"],
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d.get("intermediate_size", 4 * d["hidden_size"]),
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=heads,
            num_key_value_heads=d.get("num_key_value_heads", heads),
            head_dim=head_dim,
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scaling=d.get("rope_scaling"),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            max_position_embeddings=d.get("max_position_embeddings", 8192),
        )


class RingModel(abc.ABC):
    """A model's assigned layers + edge ops; parameters are passed in."""

    model_type: str = ""
    # layers whose attention can be swapped for the ragged paged kernel
    # (apply_window's attend_fn hook)
    supports_paged_attend: bool = False

    def __init__(self, config: ModelConfig, layers: Sequence[int], device: torch.device):
        self.config = config
        self.device = torch.device(device)
        self.layers = sorted(set(int(x) for x in layers))
        self.abs_to_local = {a: i for i, a in enumerate(self.layers)}

    @property
    def is_first(self) -> bool:
        """Holds layer 0 (embeds the tokens)."""
        return 0 in self.abs_to_local

    @property
    def is_last(self) -> bool:
        """Holds the last layer (normalizes, projects and samples)."""
        return self.config.num_hidden_layers - 1 in self.abs_to_local

    # ---- compute ------------------------------------------------------
    def embed(self, edge_params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> hidden [B, T, D]."""
        return edge_params["embed"]["weight"][tokens.long()]

    @abc.abstractmethod
    def apply_window(
        self, window_params: List[dict], x: torch.Tensor, kv: dict, pos, attend_fn=None
    ) -> Tuple[torch.Tensor, dict]:
        """Apply the window's layers; kv holds the window's stacked cache
        and is updated in place.  pos is the chunk's start position or a
        [B, 1] tensor of per-lane positions; `attend_fn`, where the model
        supports it (supports_paged_attend), replaces each layer's cache
        write and attention read."""

    @abc.abstractmethod
    def normalize(self, edge_params: dict, x: torch.Tensor) -> torch.Tensor:
        """Final norm before the LM head."""

    def lm_project(self, edge_params: dict, x: torch.Tensor) -> torch.Tensor:
        """hidden [B, T, D] -> logits [B, T, V] (tied: the embedding table,
        transposed)."""
        if self.config.tie_word_embeddings:
            return x @ edge_params["embed"]["weight"].T
        return x @ edge_params["lm_head"]["weight"]

    # ---- weight mapping ----------------------------------------------
    @abc.abstractmethod
    def map_layer(self, raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """HF per-layer tensors (prefix `model.layers.{i}.` stripped) -> our
        per-layer param dict."""

    def map_edge(self, raw: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """HF non-layer tensors -> {"embed", "final_norm", "lm_head"}."""
        out: Dict[str, Any] = {}
        if "model.embed_tokens.weight" in raw:
            out["embed"] = {"weight": raw["model.embed_tokens.weight"]}
        if "model.norm.weight" in raw:
            out["final_norm"] = {"weight": raw["model.norm.weight"]}
        if "lm_head.weight" in raw and not self.config.tie_word_embeddings:
            out["lm_head"] = {"weight": raw["lm_head.weight"].T.contiguous()}
        return out

    # ---- cache construction ------------------------------------------
    def kv_config(self, n_layers: int, batch: int, max_seq: int, dtype: str = "bfloat16") -> KVConfig:
        return KVConfig(
            n_layers=n_layers,
            batch=batch,
            max_seq=max_seq,
            n_kv_heads=self.config.num_key_value_heads,
            head_dim=self.config.head_dim,
            dtype=dtype,
        )

    def init_kv(self, n_layers: int, batch: int, max_seq: int, dtype: str = "bfloat16") -> dict:
        """Allocate the stacked [L, B, S, KVH, Hd] cache on the device."""
        return init_cache(self.kv_config(n_layers, batch, max_seq, dtype), self.device)
