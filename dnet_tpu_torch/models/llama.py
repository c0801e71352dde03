"""Llama-family model (Llama 2/3.x and checkpoints that ship qkv biases),
and the decoder that qwen2, qwen3, mixtral and qwen3_moe derive from.

Counterpart of dnet_tpu/models/llama.py: each layer runs RMSNorm -> QKV ->
RoPE -> cached attention (the CUDA kernels) -> o-proj -> SwiGLU, looping
over per-layer params where the reference scans stacked ones.

Sequence parallelism reaches the layers as the reference threads its
`sp_axis` (dnet_tpu/models/base.py:152): `apply_window(..., sp=group)`
passes the sp group down to `cached_attend`, with the cache as one shard
per rank.  The `attend_fn` hook would need no model edit, but it hands
the hook one layer's slices and stacks what it returns, which is the paged
path's contract (new rows to append), not per-rank shards written in
place; the explicit argument keeps the cache layout and the per-step
lengths as the single-device path has them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from dnet_tpu_torch.core.kvcache import layer_slices
from dnet_tpu_torch.models.base import ModelConfig, RingModel
from dnet_tpu_torch.ops.attention import cached_attend
from dnet_tpu_torch.ops.flash_decode import decode_lengths, sp_lengths
from dnet_tpu_torch.ops.norms import rms_norm
from dnet_tpu_torch.ops.quant import dq, out_dim
from dnet_tpu_torch.ops.rope import apply_rope, rope_frequencies


class LlamaRingModel(RingModel):
    model_type = "llama"
    # the standard norm->qkv->rope->attention->o-proj layer body: the
    # attention half swaps cleanly for the ragged paged kernel
    supports_paged_attend = True
    supports_sp = True

    def __init__(self, config: ModelConfig, layers, device):
        super().__init__(config, layers, device)
        inv_freq, self.rope_scale = rope_frequencies(
            config.head_dim,
            config.rope_theta,
            config.rope_scaling,
            config.max_position_embeddings,
        )
        self.inv_freq = torch.from_numpy(inv_freq).to(self.device)

    def _qk_transform(self, p: dict, q: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pre-RoPE q/k hook: the identity for llama (qwen3 adds per-head
        norms)."""
        return q, k

    def layer(
        self, p: dict, x: torch.Tensor, kvs, pos: Union[int, torch.Tensor], attend_fn=None,
        lengths=None, sp=None,
    ) -> Tuple[torch.Tensor, dict]:
        """One decoder layer; kvs is this layer's cache slices (written in
        place).  pos is the chunk's start, or a [B, 1] tensor of per-lane
        positions.  With `attend_fn` (batched slots) the caller owns both
        the cache write and the attention read: it gets (q, k, v, kvs) and
        returns (attention output, what apply_window should stack).
        `lengths` is a decode step's lengths vector, shared by the layers.
        With `sp` (an SpGroup) kvs is the list of the ranks' layer slices
        and `lengths` the ranks' vectors (ops/attention.py `cached_attend`)."""
        cfg = self.config
        B, T, _ = x.shape
        Hd = cfg.head_dim
        H = out_dim(p["wq"]) // Hd
        KVH = out_dim(p["wk"]) // Hd

        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
        q = h @ dq(p["wq"])
        k = h @ dq(p["wk"])
        v = h @ dq(p["wv"])
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q = q.reshape(B, T, H, Hd)
        k = k.reshape(B, T, KVH, Hd)
        v = v.reshape(B, T, KVH, Hd)
        q, k = self._qk_transform(p, q, k)  # subclass hook (qwen3's q/k norms)
        positions = pos + torch.arange(T, device=x.device)
        q = apply_rope(q, positions, self.inv_freq, self.rope_scale)
        k = apply_rope(k, positions, self.inv_freq, self.rope_scale)
        if attend_fn is not None:
            attn, kvs = attend_fn(q, k, v, kvs)
        else:
            attn, kvs = cached_attend(q, k, v, kvs, pos, None, causal=True, lengths=lengths, sp=sp)
        x = x + attn.reshape(B, T, H * Hd) @ dq(p["wo"])
        return self._mlp_block(p, x), kvs

    def _mlp_block(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """Post-attention SwiGLU FFN incl. the residual add; a subclass hook
        (mixtral swaps in the sparse-MoE block)."""
        h = rms_norm(x, p["mlp_norm"], self.config.rms_norm_eps)
        return x + (F.silu(h @ dq(p["w_gate"])) * (h @ dq(p["w_up"]))) @ dq(p["w_down"])

    def apply_window(
        self, window_params: List[dict], x: torch.Tensor, kv: dict,
        pos: Union[int, torch.Tensor], attend_fn=None, t_real: Optional[int] = None, sp=None,
    ) -> Tuple[torch.Tensor, dict]:
        # t_real is unused: a full-length cache keeps padded rows past every
        # real position, where the next write overwrites them
        if sp is not None:
            # kv: one stacked cache per rank (core/kvcache.py init_cache_sp);
            # a decode step's per-rank lengths vectors, made once for every layer
            lengths = None
            if x.shape[1] == 1:
                lengths = sp_lengths(x.shape[0], pos, kv[0]["k"].shape[2], sp.devices)
            for li, p in enumerate(window_params):
                x, _ = self.layer(p, x, [layer_slices(c, li) for c in kv], pos, lengths=lengths, sp=sp)
            return x, kv
        if attend_fn is None:
            # a decode step's lengths vector, made once for every layer
            lengths = decode_lengths(x.shape[0], pos, x.device) if x.shape[1] == 1 else None
            for li, p in enumerate(window_params):
                x, _ = self.layer(p, x, layer_slices(kv, li), pos, lengths=lengths)
            return x, kv
        # the hook's per-layer outputs, stacked [L, ...] (the new K/V rows the
        # caller appends to the pool)
        outs = []
        for li, p in enumerate(window_params):
            x, out = self.layer(p, x, layer_slices(kv, li), pos, attend_fn)
            outs.append(out)
        return x, {name: torch.stack([o[name] for o in outs]) for name in outs[0]}

    def normalize(self, edge_params: dict, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, edge_params["final_norm"]["weight"], self.config.rms_norm_eps)

    def map_layer(self, raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        def t(name: str) -> torch.Tensor:
            return raw[name].T.contiguous()  # HF [out, in] -> (in, out)

        out = {
            "attn_norm": raw["input_layernorm.weight"],
            "wq": t("self_attn.q_proj.weight"),
            "wk": t("self_attn.k_proj.weight"),
            "wv": t("self_attn.v_proj.weight"),
            "wo": t("self_attn.o_proj.weight"),
            "mlp_norm": raw["post_attention_layernorm.weight"],
            "w_gate": t("mlp.gate_proj.weight"),
            "w_up": t("mlp.up_proj.weight"),
            "w_down": t("mlp.down_proj.weight"),
        }
        # keyed on checkpoint contents: llama checkpoints with
        # attention_bias=true ship qkv biases
        if "self_attn.q_proj.bias" in raw:
            out["bq"] = raw["self_attn.q_proj.bias"]
            out["bk"] = raw["self_attn.k_proj.bias"]
            out["bv"] = raw["self_attn.v_proj.bias"]
        return out
