"""Carry weights across: the reference's param pytrees to the port's params,
and the port's params back to HF checkpoint tensors.

`from_jax_params` takes dnet_tpu's layer-stacked window params and edge
params as numpy arrays ((in, out)-oriented matrices with a leading layer
axis) and returns the port's per-layer list and edge dict on `device`.
`hf_tensors` is the inverse of the HF mapping (`map_layer`/`map_edge`), so
synthetic weights can be written as a checkpoint.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

from dnet_tpu_torch.models.base import ModelConfig

# llama per-layer param name -> HF suffix (matrices are stored (in, out) here
# and [out, in] in HF files)
LLAMA_HF_NAMES = {
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
}


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
    reference's stacked window params and edge params (numpy arrays)."""
    n = config.num_hidden_layers
    for name, arr in window_params.items():
        if np.shape(arr)[0] != n:
            raise ValueError(f"window param {name} stacks {np.shape(arr)[0]} layers, config has {n}")
    layers = [
        {name: _tensor(arr[i], device, dtype) for name, arr in window_params.items()}
        for i in range(n)
    ]
    edge = {
        group: {k: _tensor(a, device, dtype) for k, a in leaves.items()}
        for group, leaves in edge_params.items()
        if not (group == "lm_head" and config.tie_word_embeddings)
    }
    return layers, edge


def hf_tensors(
    window_params: List[Dict[str, torch.Tensor]],
    edge_params: Mapping[str, Mapping[str, torch.Tensor]],
) -> Dict[str, torch.Tensor]:
    """HF checkpoint tensors (names and [out, in] layout) for llama params."""
    out: Dict[str, torch.Tensor] = {}
    for i, p in enumerate(window_params):
        for name, t in p.items():
            out[f"model.layers.{i}.{LLAMA_HF_NAMES[name]}"] = t.T if t.dim() == 2 else t
    out["model.embed_tokens.weight"] = edge_params["embed"]["weight"]
    out["model.norm.weight"] = edge_params["final_norm"]["weight"]
    if "lm_head" in edge_params:
        out["lm_head.weight"] = edge_params["lm_head"]["weight"].T
    return out
