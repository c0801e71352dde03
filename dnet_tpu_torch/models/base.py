"""Layer-wise ring model abstraction.

Counterpart of dnet_tpu/models/base.py: a model over a set of assigned
absolute layers with the edge ops (embed / normalize / lm_project) and the
HF weight mapping.  Instances hold no parameters; params are passed to
every call.  Where the reference stacks layers on a leading axis for one
`lax.scan`, the port keeps a list of per-layer param dicts and loops.

Parameter layout (tensors on the engine's device):
  window params: [ {per-layer name: tensor}, ... ]  one dict per layer, or
                 whatever the model's `stack_layers` makes of that list
                 (gpt_oss: {"a": even layers, "b": odd layers}; deepseek_v2:
                 {"dense": [...], "moe": [...]})
  edge params:   {"embed": {"weight"}, "final_norm": {"weight"},
                  "lm_head": {"weight" [hidden, vocab]}  (untied only)}
Matrices are (in, out)-oriented, as in the reference, so the hot path is
`x @ W`.  Under weight-only quantization (ops/quant.py) a matrix named in
the model's `quant_keys` is an {"q" | "q4", "s"} dict instead, and every
matmul site reads it through `dq`, which passes a plain tensor through
unchanged.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from dnet_tpu_torch.config import compute_settings
from dnet_tpu_torch.core.kvcache import KVConfig, init_cache, init_cache_sp
from dnet_tpu_torch.ops.quant import QUANTIZABLE, dq, embed_lookup, is_quantized, quantize_tree, quantizer


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
    sliding_window: int = 0
    layer_types: Optional[List[str]] = None  # e.g. ["sliding_attention", "full_attention", ...]
    # MoE (gpt-oss style)
    num_local_experts: int = 0
    num_experts_per_tok: int = 0
    # the raw HF dict: MLA and MoE keys of other families (deepseek_v2)
    extra: dict = field(default_factory=dict)

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
            sliding_window=d.get("sliding_window") or 0,
            layer_types=d.get("layer_types"),
            # gpt_oss says num_local_experts; qwen3_moe says num_experts
            num_local_experts=d.get("num_local_experts", d.get("num_experts", 0)),
            num_experts_per_tok=d.get("num_experts_per_tok", 0),
            extra=d,
        )


class RingModel(abc.ABC):
    """A model's assigned layers + edge ops; parameters are passed in."""

    model_type: str = ""
    # every family's matmuls read their weights through ops/quant.py `dq`;
    # a family that cannot sets False and the engine refuses to quantize it
    supports_weight_quant: bool = True
    # per-layer param names that weight-only quantization takes (the big
    # matmuls; norms, biases, sinks and routers stay float)
    quant_keys: frozenset = QUANTIZABLE
    # the lane hook dense batched slots need (the reference's
    # supports_kv_commit): apply_window's attend_fn replaces each layer's
    # cache write and attention read, with the layer's attention settings
    # as keywords (sinks, scale, window), so the caller writes only the
    # active lanes' rows at their own positions and attends through a
    # lengths vector
    supports_kv_commit: bool = True
    # ragged eligibility (ops/paged_attention.py ragged_refusal): the layer
    # body is llama's, whose attend_fn hook may also read the pool in place
    # through the ragged paged kernel and hand back its new rows to append
    supports_paged_attend: bool = False
    # apply_window takes an sp group (sequence-parallel KV shards)
    supports_sp: bool = False
    # the window is not one flat layer list in layer order (deepseek_v2's
    # segments; a mixed qwen3_moe, which the reference stacks in segments):
    # a k-round shard cannot serve its resident layers a round at a time
    segmented_stack: bool = False

    def __init__(self, config: ModelConfig, layers: Sequence[int], device: torch.device):
        self.config = config
        self.device = torch.device(device)
        self.layers = sorted(set(int(x) for x in layers))
        self.abs_to_local = {a: i for i, a in enumerate(self.layers)}
        # MoE compute path knobs (ops/moe.py); engines and tests may
        # override the instance attributes after construction
        cs = compute_settings()
        self.moe_impl = cs.moe_impl
        self.moe_capacity_factor = cs.moe_capacity_factor

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
        """tokens [B, T] -> hidden [B, T, D] (a maybe-quantized table)."""
        return embed_lookup(edge_params["embed"]["weight"], tokens)

    @abc.abstractmethod
    def apply_window(
        self, window_params, x: torch.Tensor, kv: dict, pos, attend_fn=None, t_real: Optional[int] = None,
        sp=None,
    ) -> Tuple[torch.Tensor, dict]:
        """Apply the window's layers; kv holds the window's stacked cache
        and is updated in place.  pos is the chunk's start position or a
        [B, 1] tensor of per-lane positions; `attend_fn` (a decode row,
        supports_kv_commit) replaces each layer's cache write and attention
        read: it is called as attend_fn(q, k, v, kvs, sinks=, scale=,
        window=) with the layer's sink logits (or None), softmax scale (None:
        head_dim ** -0.5) and ring window (0 unless kvs is a W-row ring),
        and returns (attention output, what apply_window stacks: the ragged
        path's new rows, or {} when the hook wrote them).  `t_real` is the
        number of real (non-padding) tokens in the chunk: models with
        rotating ring-buffer caches keep bucket padding out of their writes,
        because padded positions would wrap around and overwrite live rows
        (None: every token is real).  `sp` (an SpGroup, parallel/mesh.py), where the
        model supports it (supports_sp): kv is one cache per sequence-
        parallel rank and attention runs as the sp composition."""

    @abc.abstractmethod
    def normalize(self, edge_params: dict, x: torch.Tensor) -> torch.Tensor:
        """Final norm before the LM head."""

    def lm_project(self, edge_params: dict, x: torch.Tensor) -> torch.Tensor:
        """hidden [B, T, D] -> logits [B, T, V] (tied: the embedding table,
        transposed; a quantized tied table is stored in the projection
        layout already, quantize_edge)."""
        if self.config.tie_word_embeddings:
            w = edge_params["embed"]["weight"]
            return x @ (dq(w) if is_quantized(w) else w.T)
        return x @ dq(edge_params["lm_head"]["weight"])

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

    # ---- weight-only quantization ------------------------------------
    def quantize_params(
        self, params: dict, bits: int, scale_dtype: Optional[torch.dtype] = None, group_size: int = 0
    ) -> dict:
        """Quantize one layer's `quant_keys` weights (ops/quant.py), on the
        device they lie on.  The reference quantizes the stacked window; the
        codes are the same per layer, and a layer at a time never holds a
        whole model's full-precision copy.  group_size 0: the bits'
        default."""
        return quantize_tree(params, self.quant_keys, bits=bits, scale_dtype=scale_dtype, group_size=group_size)

    def quantize_edge(
        self, edge: Dict[str, Any], bits: int, scale_dtype: Optional[torch.dtype] = None, group_size: int = 0
    ) -> Dict[str, Any]:
        """Quantize the LM projection among the edge params: the O(hidden x
        vocab) matrix every decode step reads in full (the embedding gather
        reads O(tokens x hidden), the norms are vectors).  A tied table is
        re-laid out to the projection orientation [hidden, vocab] (groups
        along hidden, the contraction dim); `embed_lookup` gathers its rows
        as columns, so one quantized array serves both ops and the
        full-precision table is not kept.  A tied checkpoint's serialised
        lm_head is never read and is dropped."""
        quantize, group_size = quantizer(bits, group_size)
        out = dict(edge)
        if self.config.tie_word_embeddings and "embed" in out:
            out.pop("lm_head", None)
            if not is_quantized(out["embed"]["weight"]):
                out["embed"] = {"weight": quantize(out["embed"]["weight"].T, group_size, scale_dtype)}
        elif "lm_head" in out and not is_quantized(out["lm_head"]["weight"]):
            out["lm_head"] = {"weight": quantize(out["lm_head"]["weight"], group_size, scale_dtype)}
        return out

    # ---- cache construction ------------------------------------------
    def kv_config(
        self, n_layers: int, batch: int, max_seq: int, dtype: str = "bfloat16", quant_bits: int = 0
    ) -> KVConfig:
        return KVConfig(
            n_layers=n_layers,
            batch=batch,
            max_seq=max_seq,
            n_kv_heads=self.config.num_key_value_heads,
            head_dim=self.config.head_dim,
            dtype=dtype,
            quant_bits=quant_bits,
        )

    def init_kv(
        self, n_layers: int, batch: int, max_seq: int, dtype: str = "bfloat16", quant_bits: int = 0
    ) -> dict:
        """Allocate the stacked [L, B, S, KVH, Hd] cache on the device
        (quantized: codes plus [L, B, S, KVH, 1] f32 scales).  Models with
        per-kind cache shapes override: gpt_oss returns the paired cache
        {"a": cache, "b": cache}."""
        return init_cache(self.kv_config(n_layers, batch, max_seq, dtype, quant_bits), self.device)

    def init_kv_sp(
        self, n_layers: int, batch: int, max_seq: int, dtype: str = "bfloat16", quant_bits: int = 0,
        devices: Sequence = (),
    ) -> list:
        """The sequence-parallel cache: one cache per rank, each of max_seq /
        R slots on devices[r] (core/kvcache.py `init_cache_sp`), in init_kv's
        layout.  gpt_oss overrides: a paired cache per rank."""
        return init_cache_sp(self.kv_config(n_layers, batch, max_seq, dtype, quant_bits), devices)

    # ---- weight streaming (core/weights.py) ----------------------------
    def wrap_offload_layer(self, mapped: dict, layer: int):
        """ONE layer's params shaped as a single-layer window, the unit a
        streaming engine loads and runs through apply_window (absolute
        `layer`).  Default: a one-element list; deepseek_v2 puts it in its
        segment, gpt_oss in its half."""
        return [mapped]

    def init_offload_kv(
        self, layer: int, batch: int, max_seq: int, dtype: str = "bfloat16", quant_bits: int = 0
    ) -> dict:
        """One streamed layer's own cache, in the layout its single-layer
        window reads (a streaming engine keeps the KV per layer)."""
        return init_cache(self.kv_config(1, batch, max_seq, dtype, quant_bits), self.device)

    # ---- layout -------------------------------------------------------
    def stack_layers(self, per_layer: List[dict]) -> Union[List[dict], Dict[str, List[dict]]]:
        """The window params apply_window takes, from the per-layer param
        dicts in layer order: the list itself by default; gpt_oss splits it
        into its paired halves, deepseek_v2 into its dense and moe
        segments."""
        return per_layer

    def kv_rewindable(self, max_seq: int, sp: int = 1) -> bool:
        """Whether stale cache rows past a rewound `pos` are harmless:
        slot-addressed caches qualify; rotating ring-buffer caches do not
        (a wrap-around write evicts live rows).  `sp`: the sequence-parallel
        ranks the cache is sharded over."""
        return True
