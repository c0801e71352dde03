"""Attention ops: dense GQA attention, the causal mask, and the cached
attention every layer runs.

Counterpart of dnet_tpu/ops/attention.py (the non-sequence-parallel branch
of `cached_attend`, plain and quantized caches).  With `causal=True`,
`cached_attend` writes the new k/v into the cache (quantizing it when the
cache carries scales) and then runs the hand-written kernels through
`flash_attend_causal` (ops/flash_attention.py): the decode kernel for one
query row, the prefill kernel otherwise.  A quantized cache's decode reads
the cache's own codes (no f32 copy of the cache is made); its prefill reads
the live prefix dequantized to f32 with q cast to f32 (exact: the softmax
runs in f32 anyway).  The dense `attend` stays for explicit masks and as
the reference the kernels are tested against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dnet_tpu_torch.core.kvcache import read_kv, write_kv
from dnet_tpu_torch.ops.flash_attention import flash_attend_causal

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free on fully-masked rows


def causal_mask(q_len: int, kv_len: int, q_offset: int, device=None) -> torch.Tensor:
    """[q_len, kv_len] boolean mask; True = attend.  Query i (absolute
    q_offset + i) may attend keys at absolute positions <= q_offset + i."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def cached_attend(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kvs: dict,
    pos: int,
    mask: Optional[torch.Tensor],
    sinks: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """Write the new k/v into one layer's cache slices (in place) and attend
    over the full cache.  `causal=True` (mask must be None) declares the
    standard predicate, row i attends slots [0, pos + i], and runs the
    kernels; an explicit mask runs the dense op.  `lengths` is a decode
    row's [pos + 1] * B int32 vector when the caller built it once for all
    layers (flash_attend_causal makes it otherwise)."""
    if causal and mask is not None:
        raise ValueError("cached_attend: causal=True requires mask=None")
    kvs = write_kv(kvs, k_new, v_new, pos)
    if causal and q.shape[1] == 1 and "k_scale" in kvs:
        # quantized decode: dequantize tile by tile inside the kernel;
        # read_kv would first write a full f32 copy of the cache
        out = flash_attend_causal(q, kvs["k"], kvs["v"], pos, scale=scale, sinks=sinks, lengths=lengths,
                                  k_scale=kvs["k_scale"], v_scale=kvs["v_scale"])
        return out, kvs
    if causal:
        # a quantized cache's live prefix, dequantized to f32; a plain cache whole
        kc, vc = read_kv(kvs, upto=pos + q.shape[1])
        return flash_attend_causal(q, kc, vc, pos, scale=scale, sinks=sinks, lengths=lengths), kvs
    kc, vc = read_kv(kvs)
    return attend(q, kc, vc, mask=mask, sinks=sinks, scale=scale), kvs


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped-query attention.

    q: [B, T, H, Hd];  k, v: [B, S, KVH, Hd] with H % KVH == 0.
    mask: broadcastable to [B, T, S] or [T, S]; True = attend.
    sinks: optional per-head attention-sink logits [H]: a virtual key that
      absorbs probability mass but contributes no value.
    Returns [B, T, H, Vd] in q.dtype (softmax in f32).
    """
    B, T, H, Hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else Hd**-0.5

    qf = q.reshape(B, T, KVH, G, Hd).float() * scale
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float())  # [B, KVH, G, T, S]
    if mask is not None:
        m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
        scores = torch.where(m, scores, NEG_INF)
    if sinks is not None:
        sink = sinks.float().reshape(KVH, G)[None, :, :, None, None]
        sink = sink.expand(B, KVH, G, T, 1)
        scores = torch.cat([scores, sink], dim=-1)
        probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        probs = probs / probs.sum(dim=-1, keepdim=True)
        probs = probs[..., :-1]  # drop the sink column (no value)
    else:
        probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(B, T, H, v.shape[-1]).to(q.dtype)
