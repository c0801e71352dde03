"""Carry weights across: the reference's param pytrees to the port's params,
and the port's params back to HF checkpoint tensors.

`from_jax_params` takes dnet_tpu's layer-stacked window params and edge
params, of the whole model or of a ring shard's layer range, as numpy
arrays ((in, out)-oriented matrices with a leading layer axis; gpt_oss's
paired {"a": even layers, "b": odd layers} stacks and the {"dense",
"moe"} segments of deepseek_v2 and of mixed-layout qwen3_moe too)
and returns the port's per-layer list, in global layer order, and edge
dict on `device`.  A weight the reference quantized ({"q" | "q4", "s"},
ops/quant.py) crosses unchanged: its int8 / packed-uint8 codes as they are
and its scales in their own dtype, so both packages serve the same
quantized weights.  `hf_tensors` is the inverse of the HF mapping
(`map_layer`/`map_edge`) for every family's params (stacked experts back to
per-expert tensors, under mixtral's `block_sparse_moe.*` names or the
`mlp.*` names deepseek_v2 and qwen3_moe share), so synthetic weights can be
written as a checkpoint.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dnet_tpu_torch.models.base import ModelConfig

# per-layer param name -> HF suffix, every family's (the names they share
# map alike; mixtral's router and experts are renamed in MIXTRAL_NAMES)
HF_NAMES = {
    "attn_norm": "input_layernorm.weight",
    "wq": "self_attn.q_proj.weight",
    "wk": "self_attn.k_proj.weight",
    "wv": "self_attn.v_proj.weight",
    "wo": "self_attn.o_proj.weight",
    "mlp_norm": "post_attention_layernorm.weight",
    "w_gate": "mlp.gate_proj.weight",
    "w_up": "mlp.up_proj.weight",
    "w_down": "mlp.down_proj.weight",
    "bq": "self_attn.q_proj.bias",
    "bk": "self_attn.k_proj.bias",
    "bv": "self_attn.v_proj.bias",
    "bo": "self_attn.o_proj.bias",
    "sinks": "self_attn.sinks",
    "router_w": "mlp.router.weight",
    "router_b": "mlp.router.bias",
    "gate_up": "mlp.experts.gate_up_proj",
    "gate_up_b": "mlp.experts.gate_up_proj_bias",
    "down": "mlp.experts.down_proj",
    "down_b": "mlp.experts.down_proj_bias",
    "wq_a": "self_attn.q_a_proj.weight",
    "q_a_norm": "self_attn.q_a_layernorm.weight",
    "wq_b": "self_attn.q_b_proj.weight",
    "wkv_a": "self_attn.kv_a_proj_with_mqa.weight",
    "kv_a_norm": "self_attn.kv_a_layernorm.weight",
    "wkv_b": "self_attn.kv_b_proj.weight",
    "gate_w": "mlp.gate.weight",
    "s_gate": "mlp.shared_experts.gate_proj.weight",
    "s_up": "mlp.shared_experts.up_proj.weight",
    "s_down": "mlp.shared_experts.down_proj.weight",
    "q_norm": "self_attn.q_norm.weight",
    "k_norm": "self_attn.k_norm.weight",
}
# stacked experts [E, in, out] -> per-expert HF tensors
# mlp.experts.{e}.{name}.weight (deepseek_v2, qwen3_moe)
EXPERT_NAMES = {"e_gate": "gate_proj", "e_up": "up_proj", "e_down": "down_proj"}
# mixtral's: the router and block_sparse_moe.experts.{e}.{w1|w3|w2}.weight
MIXTRAL_ROUTER = "block_sparse_moe.gate.weight"
MIXTRAL_EXPERTS = {"e_gate": "w1", "e_up": "w3", "e_down": "w2"}
# the matrices stored (in, out) here and [out, in] in HF files (gpt_oss's
# experts are (in, out) in both)
TRANSPOSED = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router_w",
    "wq_a", "wq_b", "wkv_a", "wkv_b", "gate_w", "s_gate", "s_up", "s_down",
})


def _tensor(a, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy
    return t.to(device=device, dtype=dtype)


def _exact(a, device) -> torch.Tensor:
    """A quantized weight's leaf in its own dtype: int8 / uint8 codes, f32 or
    bf16 scales (bf16 crosses through f32, which holds it exactly)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(arr.copy()).to(device)


def _leaf(a, device, dtype):
    """A reference leaf on `device`: floats as `dtype`, a quantized weight's
    {"q" | "q4", "s"} dict leaf by leaf as it is."""
    if isinstance(a, Mapping):
        return {k: _exact(v, device) for k, v in a.items()}
    return _tensor(a, device, dtype)


def _lead(a) -> int:
    return np.shape(a["s"] if isinstance(a, Mapping) else a)[0]


def _row(a, i: int):
    return {k: v[i] for k, v in a.items()} if isinstance(a, Mapping) else a[i]


def from_jax_params(
    window_params: Mapping[str, np.ndarray],
    edge_params: Mapping[str, Mapping[str, np.ndarray]],
    config: ModelConfig,
    device: Union[str, torch.device],
    dtype: torch.dtype = torch.float32,
    layers: Optional[Sequence[int]] = None,
) -> Tuple[List[Dict[str, torch.Tensor]], Dict[str, Dict[str, torch.Tensor]]]:
    """(per-layer window params, edge params) for the port from the
    reference's stacked window params and edge params (numpy arrays) of the
    absolute `layers` (None: every layer; a ring shard's range otherwise,
    with the edge params that range holds).  A paired {"a", "b"} stack
    (gpt_oss) is interleaved back into layer order (a0, b0, a1, b1, ...); a
    flat one (gpt_oss over a range whose kinds do not pair) is a plain
    stack; {"dense", "moe"} segments (deepseek_v2, mixed qwen3_moe) are
    merged in the order of the range's layer kinds (`is_moe_layer`): dense
    first for a dense prefix, interleaved for qwen3_moe's
    decoder_sparse_step layouts, either segment alone for a range that
    holds one kind."""
    layers = list(range(config.num_hidden_layers)) if layers is None else sorted(layers)
    n = len(layers)
    if set(window_params) == {"a", "b"}:
        halves = [_unstack(window_params[h], device, dtype) for h in ("a", "b")]
        out = [p for pair in zip(*halves) for p in pair]
        if len(out) != n or len(halves[0]) != len(halves[1]):
            raise ValueError(f"paired halves of {[len(h) for h in halves]} layers, the range has {n}")
        return out, _edge(edge_params, config, device, dtype)
    if set(window_params) <= {"dense", "moe"} and window_params:
        from dnet_tpu_torch.models import get_ring_model_cls

        model = get_ring_model_cls(config.model_type)(config, layers, "cpu")
        kinds = ["moe" if model.is_moe_layer(a) else "dense" for a in layers]
        segs = {seg: _unstack(window_params[seg], device, dtype) for seg in window_params}
        if {seg: len(ls) for seg, ls in segs.items()} != {seg: kinds.count(seg) for seg in set(kinds)}:
            raise ValueError(f"{sorted(window_params)} segments do not match {config.model_type}'s layer kinds "
                             f"over layers {layers}")
        rows = {seg: iter(ls) for seg, ls in segs.items()}
        out = [next(rows[kind]) for kind in kinds]
    else:
        out = _unstack(window_params, device, dtype)
    if len(out) != n:
        raise ValueError(f"window params stack {len(out)} layers, the range has {n}")
    return out, _edge(edge_params, config, device, dtype)


def _unstack(stacked: Mapping[str, np.ndarray], device, dtype) -> List[Dict[str, torch.Tensor]]:
    """Per-layer dicts from arrays with a leading layer axis."""
    counts = {_lead(arr) for arr in stacked.values()}
    if len(counts) != 1:
        raise ValueError(f"window params stack unequal layer counts {sorted(counts)}")
    return [{name: _leaf(_row(arr, i), device, dtype) for name, arr in stacked.items()} for i in range(counts.pop())]


def _edge(edge_params, config: ModelConfig, device, dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    return {
        group: {k: _leaf(a, device, dtype) for k, a in leaves.items()}
        for group, leaves in edge_params.items()
        if not (group == "lm_head" and config.tie_word_embeddings)
    }


def hf_tensors(
    window_params: List[Dict[str, torch.Tensor]],
    edge_params: Mapping[str, Mapping[str, torch.Tensor]],
    model_type: str = "llama",
) -> Dict[str, torch.Tensor]:
    """HF checkpoint tensors (names and [out, in] layout) for params of the
    family `model_type`, per layer in layer order."""
    mixtral = model_type == "mixtral"
    out: Dict[str, torch.Tensor] = {}
    for i, p in enumerate(window_params):
        for name, t in p.items():
            if name in EXPERT_NAMES:
                for e in range(t.shape[0]):
                    hf = (f"block_sparse_moe.experts.{e}.{MIXTRAL_EXPERTS[name]}" if mixtral
                          else f"mlp.experts.{e}.{EXPERT_NAMES[name]}")
                    out[f"model.layers.{i}.{hf}.weight"] = t[e].T
                continue
            hf = MIXTRAL_ROUTER if mixtral and name == "gate_w" else HF_NAMES[name]
            out[f"model.layers.{i}.{hf}"] = t.T if name in TRANSPOSED else t
    out["model.embed_tokens.weight"] = edge_params["embed"]["weight"]
    out["model.norm.weight"] = edge_params["final_norm"]["weight"]
    if "lm_head" in edge_params:
        out["lm_head.weight"] = edge_params["lm_head"]["weight"].T
    return out
