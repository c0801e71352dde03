"""GPT-OSS-family model: MoE + alternating sliding/full attention + sinks.

Counterpart of dnet_tpu/models/gpt_oss.py in its paired layout
(`_apply_paired`) and its flat one (below): gpt-oss alternates sliding
and full attention layers, so the even layers (half "a") and the odd
layers (half "b") are each of one kind.  `stack_layers` splits the per-layer params into the two
halves, `init_kv` gives each half its own cache, and the sliding half's
cache is an O(window) ring buffer (W rows instead of max_seq) read by the
decode kernel's rotating variant.  Each layer runs RMSNorm -> QKV (biases)
-> YaRN RoPE -> attention with per-head sinks (the ring, or causal over
the full cache through the prefill and decode kernels) -> o-proj (bias)
-> the routed MoE (ops/moe.py).

On batched slots (core/batch.py) a decode row of lanes at their own
positions goes through apply_window's attend hook: the sliding half's ring
is written at p % W per active lane and read by the rotating decode form
over the lengths vector (window W, sinks), the full half by the plain form.
A lane's prefill ring moves into its slot's ring unchanged: both hold
position p at p % W.

Under sequence parallelism (`apply_window(sp=)`, the reference's
`_apply_paired` with an sp axis) every rank holds a full-length flat cache
of max_seq / R slots for BOTH halves (`init_kv_sp`; the reference's
`init_kv(rotating=False)`), never a W-row ring: neither half is rotating or
causal, each attends through the dense sp attention under its per-rank
masks (`sp_sliding_window_mask` with the window, or the whole sequence
when the config has none; `sp_causal_mask`), and the sinks fold once,
after the cross-rank combine.  No kernel runs on that path, as none does in
the reference.

Weights follow the HF dequantized layout: experts as [E, D, 2F] / [E, F, D]
((in, out)-oriented already) with interleaved gate/up columns, and a
clamped SwiGLU (alpha 1.702, limit 7).

A layer range whose kinds do not pair (an odd count, as a ring shard's
range or a manual topology may give) takes the reference's flat layout:
one list in layer order over one full-length cache for every layer, each
layer under its kind's mask (causal, or the sliding window) through the
dense masked attention with sinks, as the reference's non-paired
`apply_window` runs it; no kernel runs there, and a sliding layer's
decode reads its whole cache.  It serves single sequences, resident or
streamed (a streamed flat layer is a one-layer window keyed by its kind,
{"full": [p]} or {"sliding": [p]}, over a full-length cache); batched
slots and sequence parallelism refuse it with EngineCapabilityError.

A streaming engine (core/weights.py) runs one layer at a time as a window
of its half alone ({"a": [p]} or {"b": [p]}) over that layer's own cache,
in the half's form (`init_offload_kv`: the sliding layers' W-row ring).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from dnet_tpu_torch.core.kvcache import init_cache, init_cache_sp, layer_slices
from dnet_tpu_torch.models.base import ModelConfig, RingModel
from dnet_tpu_torch.ops.attention import (
    cached_attend,
    causal_mask,
    rotating_cached_attend,
    sliding_window_mask,
    sp_causal_mask,
    sp_sliding_window_mask,
)
from dnet_tpu_torch.ops.flash_decode import decode_lengths
from dnet_tpu_torch.ops.moe import moe_apply, resolve_moe_impl
from dnet_tpu_torch.ops.norms import rms_norm
from dnet_tpu_torch.ops.quant import dq, lead_dim, out_dim
from dnet_tpu_torch.ops.rope import apply_rope, rope_frequencies

ALPHA = 1.702
LIMIT = 7.0
HALVES = ("a", "b")
# a streamed flat layer's window key, by kind (0 = full, 1 = sliding)
FLAT_KINDS = ("full", "sliding")


class GptOssRingModel(RingModel):
    model_type = "gpt_oss"
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
        resolve_moe_impl(self.moe_impl, 1, max(config.num_local_experts, 1))  # fail fast on a typo
        kinds = config.layer_types or ["full_attention"] * config.num_hidden_layers
        # kind per assigned layer (0 = full, 1 = sliding)
        self.layer_kinds: List[int] = [1 if kinds[a] == "sliding_attention" else 0 for a in self.layers]
        # paired layout: each of the even and odd halves is one kind; else
        # the flat layout (one list in layer order, a kind per layer)
        self.pair_kinds: Optional[Tuple[int, int]] = None
        if len(self.layer_kinds) >= 2 and len(self.layer_kinds) % 2 == 0:
            a, b = self.layer_kinds[0::2], self.layer_kinds[1::2]
            if len(set(a)) == 1 and len(set(b)) == 1:
                self.pair_kinds = (a[0], b[0])
        # the flat layout serves single sequences only: no lane hook, so
        # batched slots refuse it (its sp cache is refused in init_kv_sp)
        self.supports_kv_commit = self.pair_kinds is not None

    # ---- compute ------------------------------------------------------
    def _attention(
        self, p: dict, x: torch.Tensor, kvs, pos, window: int, causal: bool,
        mask, t_real: Optional[int], lengths: Optional[torch.Tensor], sp=None, attend_fn=None,
    ) -> torch.Tensor:
        """One layer's attention block incl. the residual add.  Under `sp`
        kvs is the ranks' layer slices and mask their rank-local masks; with
        `attend_fn` (batched lanes, pos [B, 1]) the hook writes and attends,
        told the ring's window (0 for a full-length half)."""
        cfg = self.config
        B, T, _ = x.shape
        Hd = cfg.head_dim
        H = out_dim(p["wq"]) // Hd
        KVH = out_dim(p["wk"]) // Hd

        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
        q = (h @ dq(p["wq"]) + p["bq"]).reshape(B, T, H, Hd)
        k = (h @ dq(p["wk"]) + p["bk"]).reshape(B, T, KVH, Hd)
        v = (h @ dq(p["wv"]) + p["bv"]).reshape(B, T, KVH, Hd)
        positions = pos + torch.arange(T, device=x.device)
        q = apply_rope(q, positions, self.inv_freq, self.rope_scale)
        k = apply_rope(k, positions, self.inv_freq, self.rope_scale)
        sinks = p["sinks"].float()  # the kernels read f32 sink logits
        if attend_fn is not None:
            attn, _ = attend_fn(q, k, v, kvs, sinks=sinks, window=window)
        elif window:
            attn, _ = rotating_cached_attend(q, k, v, kvs, pos, window, sinks=sinks, t_real=t_real,
                                             lengths=lengths)
        else:
            attn, _ = cached_attend(q, k, v, kvs, pos, mask, sinks=sinks, causal=causal, lengths=lengths, sp=sp)
        return x + (attn.reshape(B, T, H * Hd) @ dq(p["wo"]) + p["bo"])

    def _moe(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        h = rms_norm(x, p["mlp_norm"], self.config.rms_norm_eps)
        flat = h.reshape(B * T, D)
        N = flat.shape[0]
        k = self.config.num_experts_per_tok
        E = lead_dim(p["gate_up"])

        logits = flat @ p["router_w"] + p["router_b"]  # [N, E]
        top_vals, top_idx = torch.topk(logits, k, dim=-1)
        top_probs = torch.softmax(top_vals.float(), dim=-1).to(flat.dtype)

        def glu(gu: torch.Tensor) -> torch.Tensor:
            # gate and up are the INTERLEAVED columns of the fused projection
            gate = torch.clamp(gu[..., ::2], max=LIMIT)
            up = torch.clamp(gu[..., 1::2], min=-LIMIT, max=LIMIT)
            return (up + 1.0) * (gate * torch.sigmoid(gate * ALPHA))

        def ffn(xe: torch.Tensor) -> torch.Tensor:  # per-expert buffers [E, C, D] -> [E, C, D]
            gu = torch.bmm(xe, dq(p["gate_up"])) + p["gate_up_b"][:, None, :]
            return torch.bmm(glu(gu), dq(p["down"])) + p["down_b"][:, None, :]

        def dense() -> torch.Tensor:  # every token x every expert, scores mask the sum
            scores = torch.zeros_like(logits).scatter(1, top_idx, top_probs)
            # [N, D] @ [E, D, 2F] broadcasts to one batched product over the
            # experts' weights as stored (an einsum would copy them into a
            # [D, E * 2F] matrix first)
            expert_out = ffn(flat.expand(E, N, D))  # [E, N, D]
            return torch.einsum("end,ne->nd", expert_out, scores)

        out = moe_apply(self.moe_impl, flat, top_idx, top_probs, ffn, E, self.moe_capacity_factor, k, dense)
        return x + out.reshape(B, T, D)

    def apply_window(
        self, window_params: Dict[str, List[dict]], x: torch.Tensor, kv: dict, pos: int,
        attend_fn=None, t_real: Optional[int] = None, sp=None,
    ) -> Tuple[torch.Tensor, dict]:
        """The paired layers in order (a0, b0, a1, b1, ...), each half over
        its own cache kv[half]; returns (x, kv) with kv written in place.
        Under `sp` kv is the ranks' paired caches (`init_kv_sp`).  With
        `attend_fn` (a decode row of batched lanes, pos [B, 1]) each layer's
        write and read go through the hook: the sliding half's ring with
        window W, the full half (and a sliding half over a full-length
        cache, whose window covers every position) with window 0.  The
        flat layout takes `_apply_flat` (no sp, no lane hook)."""
        if self.pair_kinds is None:
            return self._apply_flat(window_params, x, kv, pos, t_real), kv
        if sp is not None:
            return self._apply_sp(window_params, x, kv, pos, sp), kv
        T = x.shape[1]
        W_cfg = self.config.sliding_window
        # both halves, or one (a streamed layer's single-layer window)
        halves = [h for h in HALVES if h in window_params]
        ctx = {}
        for h, kind in zip(HALVES, self.pair_kinds):
            if h not in window_params:
                continue
            S_h = kv[h]["k"].shape[2]
            # a W-row cache marks the ring-buffer layout (init_kv sizes a
            # sliding half to W only when W < max_seq)
            rotating = kind == 1 and 0 < W_cfg == S_h
            causal = kind == 0
            mask = None
            if kind == 1 and not rotating and attend_fn is None:  # a sliding half over a full-length cache
                mask = sliding_window_mask(T, S_h, pos, W_cfg or S_h, device=x.device)
            ctx[h] = (W_cfg if rotating else 0, causal, mask)
        # a decode step's lengths vector, made once for every layer
        lengths = decode_lengths(x.shape[0], pos, x.device) if T == 1 and attend_fn is None else None
        for i in range(len(window_params[halves[0]])):
            for h in halves:
                p = window_params[h][i]
                window, causal, mask = ctx[h]
                x = self._attention(p, x, layer_slices(kv[h], i), pos, window, causal, mask, t_real, lengths,
                                    attend_fn=attend_fn)
                x = self._moe(p, x)
        return x, kv

    def _apply_flat(self, window_params, x: torch.Tensor, kv: dict, pos: int, t_real: Optional[int]) -> torch.Tensor:
        """The flat layout, the reference's non-paired body: the layers in
        order over one full-length cache, each under its kind's mask (the
        sliding window or causal), with sinks, through the dense masked
        attention (no kernel: the reference passes an explicit mask to
        cached_attend too).  `window_params` is the layer list, or a
        streamed layer's one-layer window keyed by its kind."""
        if isinstance(window_params, dict):  # {"full" | "sliding": [p]}
            (name, layers), = window_params.items()
            kinds = [FLAT_KINDS.index(name)] * len(layers)
        else:
            layers, kinds = window_params, self.layer_kinds
        T, S = x.shape[1], kv["k"].shape[2]
        masks = (causal_mask(T, S, pos, device=x.device),
                 sliding_window_mask(T, S, pos, self.config.sliding_window or S, device=x.device))
        for i, (p, kind) in enumerate(zip(layers, kinds)):
            x = self._attention(p, x, layer_slices(kv, i), pos, 0, False, masks[kind], t_real, None)
            x = self._moe(p, x)
        return x

    def sp_kind_masks(self, kind: int, T: int, S_local: int, pos: int, sp) -> list:
        """One half's rank-local [T, S_local] masks under sp, on each rank's
        device (the reference's `_kind_mask` with an sp axis): the sliding
        window (the whole sequence when the config has none) for kind 1,
        causal for kind 0."""
        swa = self.config.sliding_window or S_local * sp.size
        if kind == 1:
            return [sp_sliding_window_mask(T, S_local, pos, swa, r, d) for r, d in enumerate(sp.devices)]
        return [sp_causal_mask(T, S_local, pos, r, d) for r, d in enumerate(sp.devices)]

    def _apply_sp(self, window_params: Dict[str, List[dict]], x: torch.Tensor, kv: list, pos: int, sp) -> torch.Tensor:
        """The paired layers under sequence parallelism: each half over the
        ranks' flat caches with its kind's rank-local masks (made once for
        every layer); returns x."""
        S_local = kv[0]["a"]["k"].shape[2]
        masks = {h: self.sp_kind_masks(kind, x.shape[1], S_local, pos, sp) for h, kind in zip(HALVES, self.pair_kinds)}
        for i in range(len(window_params["a"])):
            for h in HALVES:
                p = window_params[h][i]
                x = self._attention(p, x, [layer_slices(c[h], i) for c in kv], pos, 0, False, masks[h], None, None,
                                    sp=sp)
                x = self._moe(p, x)
        return x

    def normalize(self, edge_params: dict, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, edge_params["final_norm"]["weight"], self.config.rms_norm_eps)

    # ---- layout -------------------------------------------------------
    def stack_layers(self, per_layer: List[dict]) -> Union[List[dict], Dict[str, List[dict]]]:
        """The paired halves, or the flat layout's list as it is."""
        if self.pair_kinds is None:
            return per_layer
        return {"a": per_layer[0::2], "b": per_layer[1::2]}

    def init_kv(
        self, n_layers: int, batch: int, max_seq: int, dtype: str = "bfloat16", quant_bits: int = 0
    ) -> dict:
        """The paired cache {"a": cache, "b": cache}, each of n_layers / 2
        layers; a sliding half is a ring of W rows when W < max_seq.  The
        flat layout: one full-length cache for every layer."""
        if n_layers != len(self.layers):
            raise ValueError(f"gpt_oss caches cover all {len(self.layers)} layers, not {n_layers}")
        if self.pair_kinds is None:
            return super().init_kv(n_layers, batch, max_seq, dtype, quant_bits)
        W = self.config.sliding_window

        def cache(kind: int) -> dict:
            s = W if kind == 1 and 0 < W < max_seq else max_seq
            return init_cache(self.kv_config(n_layers // 2, batch, s, dtype, quant_bits), self.device)

        return {h: cache(kind) for h, kind in zip(HALVES, self.pair_kinds)}

    def _half(self, layer: int) -> str:
        """The half an (absolute) layer belongs to: even local positions
        are "a", odd ones "b"."""
        return HALVES[self.abs_to_local[layer] % 2]

    def wrap_offload_layer(self, mapped: dict, layer: int) -> Dict[str, List[dict]]:
        """One layer as a one-layer window of its half (flat: keyed by its
        kind)."""
        if self.pair_kinds is None:
            return {FLAT_KINDS[self.layer_kinds[self.abs_to_local[layer]]]: [mapped]}
        return {self._half(layer): [mapped]}

    def init_offload_kv(
        self, layer: int, batch: int, max_seq: int, dtype: str = "bfloat16", quant_bits: int = 0
    ) -> dict:
        """A streamed layer's cache in its half's form: a W-row ring for a
        sliding layer when W < max_seq, else max_seq rows (flat: always
        max_seq rows)."""
        if self.pair_kinds is None:
            return super().init_offload_kv(layer, batch, max_seq, dtype, quant_bits)
        kind = self.pair_kinds[HALVES.index(self._half(layer))]
        W = self.config.sliding_window
        s = W if kind == 1 and 0 < W < max_seq else max_seq
        return {self._half(layer): init_cache(self.kv_config(1, batch, s, dtype, quant_bits), self.device)}

    def init_kv_sp(
        self, n_layers: int, batch: int, max_seq: int, dtype: str = "bfloat16", quant_bits: int = 0,
        devices=(),
    ) -> list:
        """One paired cache per sequence-parallel rank, {"a": cache, "b":
        cache} of n_layers / 2 layers each, both halves max_seq / R slots
        (never a ring: the reference's init_kv(rotating=False) under sp)."""
        if n_layers != len(self.layers):
            raise ValueError(f"gpt_oss caches cover all {len(self.layers)} layers, not {n_layers}")
        if self.pair_kinds is None:  # no reference path reaches it from a shard
            from dnet_tpu_torch.api.inference import EngineCapabilityError

            raise EngineCapabilityError(f"gpt_oss layers {self.layers} with kinds {self.layer_kinds} take the flat "
                                        "layout, which has no sequence-parallel form")
        cfg = self.kv_config(n_layers // 2, batch, max_seq, dtype, quant_bits)
        halves = {h: init_cache_sp(cfg, devices) for h in HALVES}
        return [{h: halves[h][r] for h in HALVES} for r in range(len(devices))]

    def kv_rewindable(self, max_seq: int, sp: int = 1) -> bool:
        """False when init_kv allocates a ring-buffer half: wrap-around
        writes evict live rows, so a rewind would corrupt the window.  Under
        sp (sp > 1) no half is a ring, nor in the flat layout."""
        W = self.config.sliding_window
        return sp > 1 or self.pair_kinds is None or not (0 < W < max_seq and 1 in self.pair_kinds)

    # ---- weight mapping ----------------------------------------------
    def map_layer(self, raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        def t(name: str) -> torch.Tensor:
            return raw[name].T.contiguous()  # HF [out, in] -> (in, out)

        return {
            "attn_norm": raw["input_layernorm.weight"],
            "wq": t("self_attn.q_proj.weight"),
            "bq": raw["self_attn.q_proj.bias"],
            "wk": t("self_attn.k_proj.weight"),
            "bk": raw["self_attn.k_proj.bias"],
            "wv": t("self_attn.v_proj.weight"),
            "bv": raw["self_attn.v_proj.bias"],
            "wo": t("self_attn.o_proj.weight"),
            "bo": raw["self_attn.o_proj.bias"],
            "sinks": raw["self_attn.sinks"],
            "mlp_norm": raw["post_attention_layernorm.weight"],
            "router_w": t("mlp.router.weight"),
            "router_b": raw["mlp.router.bias"],
            # experts are stored [E, D, 2F] / [E, F, D]: already (in, out)
            "gate_up": raw["mlp.experts.gate_up_proj"],
            "gate_up_b": raw["mlp.experts.gate_up_proj_bias"],
            "down": raw["mlp.experts.down_proj"],
            "down_b": raw["mlp.experts.down_proj_bias"],
        }
