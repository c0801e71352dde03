"""DeepSeek-V2-family model: MLA attention + shared/routed MoE.

Counterpart of dnet_tpu/models/deepseek_v2.py on one device or over
sequence-parallel ranks (`apply_window(sp=)`: each rank's shard of the
asymmetric cache, a decode row through the decode kernel's LSE form at
(192, 128); no tensor or pipeline parallelism).  Each layer runs:

- MLA: queries through an optional LoRA (q_a -> norm -> q_b; absent on
  V2-Lite), keys and values through a compressed latent (kv_a -> norm ->
  kv_b) plus one rope key shared by every head; rope in the interleaved
  (complex-pair) convention.  K caches nope + rope (qk_head_dim, 192 at the
  published widths) and V its own width (v_head_dim, 128): an asymmetric
  cache with as many KV heads as query heads, attended by the prefill and
  decode kernels at (Dqk, Dv) = (192, 128) with the model's softmax scale
  (YaRN's mscale(factor, mscale_all_dim)^2 applied, as the model was
  trained; transformers drops it).
- Layers below `first_k_dense_replace` a dense SwiGLU MLP; the rest MoE:
  a softmax over all experts' router logits in f32, then top-k (greedy or
  group-limited), `norm_topk_prob`, `routed_scaling_factor`, the routed
  experts through ops/moe.py, plus the always-on shared experts.

On batched slots (core/batch.py: dense slots, or a view gathered from the
paged pool) a decode row of lanes goes through apply_window's attend hook:
each active lane's 192-wide K and 128-wide V rows are written at its
position, then the decode kernel's (192, 128) form attends every lane over
the lengths vector at the model's softmax scale.

Dense and MoE layers carry different params, so the window stacks as
{"dense": [...], "moe": [...]} (models/segments.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from dnet_tpu_torch.core.kvcache import KVConfig
from dnet_tpu_torch.models.base import ModelConfig, RingModel
from dnet_tpu_torch.models.segments import SEGMENTS, TwoSegmentStackMixin
from dnet_tpu_torch.ops.attention import cached_attend
from dnet_tpu_torch.ops.flash_decode import decode_lengths, sp_lengths
from dnet_tpu_torch.ops.moe import moe_apply, resolve_moe_impl, swiglu_expert_closures
from dnet_tpu_torch.ops.norms import rms_norm
from dnet_tpu_torch.ops.quant import dq
from dnet_tpu_torch.ops.rope import apply_rope_interleaved, rope_frequencies


class DeepseekV2RingModel(TwoSegmentStackMixin, RingModel):
    model_type = "deepseek_v2"
    supports_sp = True
    segmented_stack = True  # {"dense": [...], "moe": [...]}
    # the reference's set: the MLA projections, the dense MLP, the routed
    # and shared experts (the router gate_w stays f32: routing decisions are
    # precision-sensitive)
    quant_keys = frozenset({
        "wq", "wq_a", "wq_b", "wkv_a", "wkv_b", "wo",
        "w_gate", "w_up", "w_down",
        "e_gate", "e_up", "e_down", "s_gate", "s_up", "s_down",
    })

    def __init__(self, config: ModelConfig, layers, device):
        super().__init__(config, layers, device)
        x = config.extra
        self.q_lora_rank = x.get("q_lora_rank")
        self.qk_nope_head_dim = x.get("qk_nope_head_dim", 128)
        self.qk_rope_head_dim = x.get("qk_rope_head_dim", 64)
        self.kv_lora_rank = x.get("kv_lora_rank", 512)
        self.v_head_dim = x.get("v_head_dim", 128)
        self.qk_head_dim = self.qk_nope_head_dim + self.qk_rope_head_dim
        self.n_routed_experts = x.get("n_routed_experts", 0)
        self.first_k_dense_replace = x.get("first_k_dense_replace", 0)
        self.routed_scaling_factor = x.get("routed_scaling_factor", 1.0)
        self.topk_method = x.get("topk_method", "greedy")
        self.n_group = x.get("n_group", 1)
        self.topk_group = x.get("topk_group", 1)
        self.norm_topk_prob = x.get("norm_topk_prob", False)
        self.num_experts_per_tok = x.get("num_experts_per_tok", 0)
        resolve_moe_impl(self.moe_impl, 1, max(self.n_routed_experts, 1))  # fail fast on a typo

        inv_freq, self.rope_scale = rope_frequencies(
            self.qk_rope_head_dim,
            config.rope_theta,
            config.rope_scaling,
            config.max_position_embeddings,
        )
        self.inv_freq = torch.from_numpy(inv_freq).to(self.device)
        # DeepSeek-V2's YaRN compensates the softmax scale by
        # mscale(factor, mscale_all_dim)^2
        self.softmax_scale = self.qk_head_dim**-0.5
        rs = config.rope_scaling or {}
        if rs.get("rope_type", rs.get("type")) == "yarn":
            factor = rs.get("factor", 1.0)
            msc_all = rs.get("mscale_all_dim", 0)
            if msc_all and factor > 1:
                mscale = 0.1 * msc_all * math.log(factor) + 1.0
                self.softmax_scale = self.softmax_scale * mscale * mscale

    def is_moe_layer(self, abs_layer: int) -> bool:
        return self.n_routed_experts > 0 and abs_layer >= self.first_k_dense_replace

    # ---- cache: asymmetric dims, one KV head per query head -------------
    def kv_config(
        self, n_layers: int, batch: int, max_seq: int, dtype: str = "bfloat16", quant_bits: int = 0
    ) -> KVConfig:
        return KVConfig(
            n_layers=n_layers,
            batch=batch,
            max_seq=max_seq,
            n_kv_heads=self.config.num_attention_heads,
            head_dim=self.qk_head_dim,
            dtype=dtype,
            v_head_dim=self.v_head_dim,
            quant_bits=quant_bits,
        )

    # ---- compute ------------------------------------------------------
    def _attention(
        self, p: dict, x: torch.Tensor, kvs, pos, lengths, sp=None, attend_fn=None
    ) -> torch.Tensor:
        """MLA incl. the residual add; under `sp` kvs is the ranks' layer
        slices and lengths their vectors (ops/attention.py cached_attend):
        the predicate stays the implicit causal one, as in the reference.
        With `attend_fn` (batched lanes, pos [B, 1]) the hook writes the
        192-wide K and 128-wide V rows and attends at the model's scale."""
        B, T, _ = x.shape
        nope, rope_d, vd = self.qk_nope_head_dim, self.qk_rope_head_dim, self.v_head_dim

        h = rms_norm(x, p["attn_norm"], self.config.rms_norm_eps)
        if self.q_lora_rank is None:
            q = h @ dq(p["wq"])
        else:
            q = rms_norm(h @ dq(p["wq_a"]), p["q_a_norm"], 1e-6) @ dq(p["wq_b"])
        H = q.shape[-1] // self.qk_head_dim
        q = q.reshape(B, T, H, self.qk_head_dim)
        q_nope, q_pe = q[..., :nope], q[..., nope:]

        ckv = h @ dq(p["wkv_a"])  # [B, T, kv_lora_rank + rope_d]
        k_latent, k_pe = ckv[..., : self.kv_lora_rank], ckv[..., self.kv_lora_rank :]
        k_latent = rms_norm(k_latent, p["kv_a_norm"], 1e-6)
        kv = (k_latent @ dq(p["wkv_b"])).reshape(B, T, H, nope + vd)
        k_nope, v = kv[..., :nope], kv[..., nope:]

        positions = pos + torch.arange(T, device=x.device)
        q_pe = apply_rope_interleaved(q_pe, positions, self.inv_freq, self.rope_scale)
        # one rope key for every head (MQA-style)
        k_pe = apply_rope_interleaved(k_pe[:, :, None, :], positions, self.inv_freq, self.rope_scale)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        k_full = torch.cat([k_nope, k_pe.expand(B, T, H, rope_d)], dim=-1)
        if attend_fn is not None:
            attn, _ = attend_fn(q_full, k_full, v, kvs, scale=self.softmax_scale)
        else:
            attn, _ = cached_attend(q_full, k_full, v, kvs, pos, None, scale=self.softmax_scale, causal=True,
                                    lengths=lengths, sp=sp)
        return x + attn.reshape(B, T, H * vd) @ dq(p["wo"])

    @staticmethod
    def _dense_mlp(h: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
        return (F.silu(h @ dq(w_gate)) * (h @ dq(w_up))) @ dq(w_down)

    def _route(self, flat: torch.Tensor, gate_w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(top_idx [N, k], top_w [N, k] f32): a softmax over every expert's
        router logit in f32, then the greedy or group-limited top-k."""
        scores = torch.softmax(flat.float() @ gate_w.float(), dim=-1)  # [N, E]
        k = self.num_experts_per_tok
        if self.topk_method == "group_limited_greedy":
            N, E = scores.shape
            g = self.n_group
            group_scores = scores.reshape(N, g, E // g).amax(dim=-1)
            group_idx = torch.topk(group_scores, self.topk_group, dim=-1).indices
            group_mask = torch.zeros_like(group_scores).scatter(1, group_idx, 1.0)
            score_mask = group_mask.repeat_interleave(E // g, dim=1)
            top_w, top_idx = torch.topk(torch.where(score_mask > 0, scores, 0.0), k, dim=-1)
        else:  # greedy (DeepSeek-V2-Lite)
            top_w, top_idx = torch.topk(scores, k, dim=-1)
        if self.norm_topk_prob:
            top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        return top_idx, top_w * self.routed_scaling_factor

    def _moe(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        h = rms_norm(x, p["mlp_norm"], self.config.rms_norm_eps)
        flat = h.reshape(B * T, D)
        top_idx, top_w = self._route(flat, p["gate_w"])
        effn, dense, E = swiglu_expert_closures(p, flat, top_idx, top_w)
        routed = moe_apply(self.moe_impl, flat, top_idx, top_w, effn, E, self.moe_capacity_factor,
                           self.num_experts_per_tok, dense)
        shared = self._dense_mlp(flat, p["s_gate"], p["s_up"], p["s_down"])
        return x + (routed.to(flat.dtype) + shared).reshape(B, T, D)

    def layer(
        self, p: dict, x: torch.Tensor, kvs, pos, lengths=None, sp=None, attend_fn=None
    ) -> Tuple[torch.Tensor, dict]:
        """One decoder layer over its cache slices (written in place; under
        `sp` the ranks' slices; with `attend_fn`, through the lane hook)."""
        x = self._attention(p, x, kvs, pos, lengths, sp, attend_fn)
        if "e_gate" in p:
            return self._moe(p, x), kvs
        h = rms_norm(x, p["mlp_norm"], self.config.rms_norm_eps)
        return x + self._dense_mlp(h, p["w_gate"], p["w_up"], p["w_down"]), kvs

    def apply_window(
        self, window_params: Dict[str, List[dict]], x: torch.Tensor, kv: dict, pos: int,
        attend_fn=None, t_real: Optional[int] = None, sp=None,
    ) -> Tuple[torch.Tensor, dict]:
        """The dense segment, then the moe segment; kv written in place
        (under `sp`: one cache per rank, core/kvcache.py init_cache_sp).
        t_real is unused: a full-length cache keeps padded rows past every
        real position, where the next write overwrites them.  `attend_fn`:
        a decode row of batched lanes through the lane hook (pos [B, 1])."""
        if attend_fn is not None:
            return self._apply_segments(window_params, x, kv, pos, attend_fn=attend_fn), kv
        # a decode step's lengths vector (per rank under sp), made once for every layer
        lengths = None
        if x.shape[1] == 1:
            lengths = (decode_lengths(x.shape[0], pos, x.device) if sp is None
                       else sp_lengths(x.shape[0], pos, kv[0]["k"].shape[2], sp.devices))
        return self._apply_segments(window_params, x, kv, pos, lengths, sp), kv

    def normalize(self, edge_params: dict, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, edge_params["final_norm"]["weight"], self.config.rms_norm_eps)

    # ---- layout -------------------------------------------------------
    def stack_layers(self, per_layer: List[dict]) -> Dict[str, List[dict]]:
        """The two segments: the window's dense prefix and its moe suffix
        (dense layers come first in the model, so a contiguous range is
        always dense-then-moe)."""
        n_dense = sum(1 for a in self.layers if not self.is_moe_layer(a))
        segs = dict(zip(SEGMENTS, (per_layer[:n_dense], per_layer[n_dense:])))
        return {seg: layers for seg, layers in segs.items() if layers}

    # ---- weight mapping ----------------------------------------------
    def map_layer(self, raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        def t(name: str) -> torch.Tensor:
            return raw[name].T.contiguous()  # HF [out, in] -> (in, out)

        p = {
            "attn_norm": raw["input_layernorm.weight"],
            "mlp_norm": raw["post_attention_layernorm.weight"],
            "wkv_a": t("self_attn.kv_a_proj_with_mqa.weight"),
            "kv_a_norm": raw["self_attn.kv_a_layernorm.weight"],
            "wkv_b": t("self_attn.kv_b_proj.weight"),
            "wo": t("self_attn.o_proj.weight"),
        }
        if "self_attn.q_proj.weight" in raw:
            p["wq"] = t("self_attn.q_proj.weight")
        else:
            p["wq_a"] = t("self_attn.q_a_proj.weight")
            p["q_a_norm"] = raw["self_attn.q_a_layernorm.weight"]
            p["wq_b"] = t("self_attn.q_b_proj.weight")
        if "mlp.gate.weight" in raw:  # MoE layer
            p["gate_w"] = t("mlp.gate.weight")
            n_experts = 0
            while f"mlp.experts.{n_experts}.gate_proj.weight" in raw:
                n_experts += 1
            for name, hf in (("e_gate", "gate_proj"), ("e_up", "up_proj"), ("e_down", "down_proj")):
                p[name] = torch.stack([t(f"mlp.experts.{e}.{hf}.weight") for e in range(n_experts)])
            p["s_gate"] = t("mlp.shared_experts.gate_proj.weight")
            p["s_up"] = t("mlp.shared_experts.up_proj.weight")
            p["s_down"] = t("mlp.shared_experts.down_proj.weight")
        else:  # dense layer
            p["w_gate"] = t("mlp.gate_proj.weight")
            p["w_up"] = t("mlp.up_proj.weight")
            p["w_down"] = t("mlp.down_proj.weight")
        return p
