"""Carry weights across: the reference's param pytrees to the port's params,
and the port's params back to HF checkpoint tensors.

`from_jax_params` takes dnet_tpu's layer-stacked window params and edge
params as numpy arrays ((in, out)-oriented matrices with a leading layer
axis; gpt_oss's paired {"a": even layers, "b": odd layers} stacks and
deepseek_v2's {"dense": prefix, "moe": suffix} segments too) and returns
the port's per-layer list, in layer order, and edge dict on `device`.
`hf_tensors` is the inverse of the HF mapping (`map_layer`/`map_edge`) for
llama, gpt_oss and deepseek_v2 params (deepseek's stacked experts back to
per-expert `mlp.experts.{e}.*` tensors), so synthetic weights can be
written as a checkpoint.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

from dnet_tpu_torch.models.base import ModelConfig

# per-layer param name -> HF suffix, llama's, gpt_oss's and deepseek_v2's
# (the names they share map alike)
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
}
# deepseek_v2's stacked experts [E, in, out] -> per-expert HF tensors
EXPERT_NAMES = {"e_gate": "gate_proj", "e_up": "up_proj", "e_down": "down_proj"}
# the matrices stored (in, out) here and [out, in] in HF files (gpt_oss's
# experts are (in, out) in both)
TRANSPOSED = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router_w",
    "wq_a", "wq_b", "wkv_a", "wkv_b", "gate_w", "s_gate", "s_up", "s_down",
})


def _tensor(a, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy
    return t.to(device=device, dtype=dtype)


def from_jax_params(
    window_params: Mapping[str, np.ndarray],
    edge_params: Mapping[str, Mapping[str, np.ndarray]],
    config: ModelConfig,
    device: Union[str, torch.device],
    dtype: torch.dtype = torch.float32,
) -> Tuple[List[Dict[str, torch.Tensor]], Dict[str, Dict[str, torch.Tensor]]]:
    """(per-layer window params, edge params) for the port from the
    reference's stacked window params and edge params (numpy arrays).  A
    paired {"a", "b"} stack (gpt_oss) is interleaved back into layer order
    (a0, b0, a1, b1, ...); {"dense", "moe"} segments (deepseek_v2) are
    concatenated, dense first."""
    n = config.num_hidden_layers
    if set(window_params) == {"a", "b"}:
        halves = [_unstack(window_params[h], device, dtype) for h in ("a", "b")]
        layers = [p for pair in zip(*halves) for p in pair]
        if len(layers) != n or len(halves[0]) != len(halves[1]):
            raise ValueError(f"paired halves of {[len(h) for h in halves]} layers, config has {n}")
        return layers, _edge(edge_params, config, device, dtype)
    if set(window_params) <= {"dense", "moe"} and window_params:
        layers = [p for seg in ("dense", "moe") if seg in window_params
                  for p in _unstack(window_params[seg], device, dtype)]
    else:
        layers = _unstack(window_params, device, dtype)
    if len(layers) != n:
        raise ValueError(f"window params stack {len(layers)} layers, config has {n}")
    return layers, _edge(edge_params, config, device, dtype)


def _unstack(stacked: Mapping[str, np.ndarray], device, dtype) -> List[Dict[str, torch.Tensor]]:
    """Per-layer dicts from arrays with a leading layer axis."""
    counts = {np.shape(arr)[0] for arr in stacked.values()}
    if len(counts) != 1:
        raise ValueError(f"window params stack unequal layer counts {sorted(counts)}")
    return [{name: _tensor(arr[i], device, dtype) for name, arr in stacked.items()} for i in range(counts.pop())]


def _edge(edge_params, config: ModelConfig, device, dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    return {
        group: {k: _tensor(a, device, dtype) for k, a in leaves.items()}
        for group, leaves in edge_params.items()
        if not (group == "lm_head" and config.tie_word_embeddings)
    }


def hf_tensors(
    window_params: List[Dict[str, torch.Tensor]],
    edge_params: Mapping[str, Mapping[str, torch.Tensor]],
) -> Dict[str, torch.Tensor]:
    """HF checkpoint tensors (names and [out, in] layout) for llama,
    gpt_oss or deepseek_v2 params, per layer in layer order."""
    out: Dict[str, torch.Tensor] = {}
    for i, p in enumerate(window_params):
        for name, t in p.items():
            if name in EXPERT_NAMES:
                for e in range(t.shape[0]):
                    out[f"model.layers.{i}.mlp.experts.{e}.{EXPERT_NAMES[name]}.weight"] = t[e].T
                continue
            out[f"model.layers.{i}.{HF_NAMES[name]}"] = t.T if name in TRANSPOSED else t
    out["model.embed_tokens.weight"] = edge_params["embed"]["weight"]
    out["model.norm.weight"] = edge_params["final_norm"]["weight"]
    if "lm_head" in edge_params:
        out["lm_head.weight"] = edge_params["lm_head"]["weight"].T
    return out
