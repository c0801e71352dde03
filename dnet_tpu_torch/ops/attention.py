"""Attention ops: dense GQA attention, the causal and sliding-window
masks, and the cached attention every layer runs.

Counterpart of dnet_tpu/ops/attention.py (`cached_attend` with its
sequence-parallel branch, and `rotating_cached_attend`, plain and
quantized caches).  With `causal=True`,
`cached_attend` writes the new k/v into the cache (quantizing it when the
cache carries scales) and then runs the hand-written kernels through
`flash_attend_causal` (ops/flash_attention.py): the decode kernel for one
query row, the prefill kernel otherwise.  A quantized cache's decode reads
the cache's own codes (no f32 copy of the cache is made); its prefill reads
the live prefix dequantized to f32 with q cast to f32 (exact: the softmax
runs in f32 anyway).  The dense `attend` stays for explicit masks and as
the reference the kernels are tested against.

With an sp group (`sp=`, parallel/mesh.py) the cache is one shard per
rank and `cached_attend` writes each new key on the rank that owns its
slot (core/kvcache.py `write_kv_sp`); a decode row then runs the decode
kernel's LSE form on every rank (over a quantized cache's codes) and one
log-sum-exp combine (ops/ring_attention.py `sp_flash_decode_attend`), and
a prompt chunk the dense `sp_decode_attend` under each rank's
`sp_causal_mask`, as the reference does (its kernel composition takes one
query row only).  A caller's rank-local masks (gpt_oss's sliding and full
halves under sp) take the dense path for decode rows too, as in the
reference.

`rotating_cached_attend` is gpt_oss's sliding-window layer over an
O(window) ring-buffer cache: a decode row writes the ring first and reads
it through the decode kernel's rotating variant; a prompt chunk attends the
ring as it was plus its own keys through the dense `attend`, with masks
built from each slot's absolute position, and writes the ring after.

`lane_cached_attend` is the batched engine's decode row over lanes at
their own positions (the reference's vmap with `kv_commit=active`): it
writes only the active lanes' new rows, at position p (a W-row ring: slot
p % W), then one decode-kernel launch attends every lane through its
lengths vector (0 for an idle lane), in the plain, rotating or (192, 128)
MLA form and over a quantized cache's codes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from dnet_tpu_torch.core.kvcache import read_kv, write_kv, write_kv_rotating, write_kv_rows, write_kv_sp
from dnet_tpu_torch.ops.flash_attention import flash_attend_causal
from dnet_tpu_torch.ops.flash_decode import decode_lengths, flash_decode_attend, rank_live, sp_lengths
from dnet_tpu_torch.ops.ring_attention import sp_decode_attend, sp_flash_decode_attend

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free on fully-masked rows


def causal_mask(q_len: int, kv_len: int, q_offset: int, device=None) -> torch.Tensor:
    """[q_len, kv_len] boolean mask; True = attend.  Query i (absolute
    q_offset + i) may attend keys at absolute positions <= q_offset + i."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def sliding_window_mask(q_len: int, kv_len: int, q_offset: int, window: int, device=None) -> torch.Tensor:
    """Causal mask further restricted to the last `window` keys."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos) & (kv_pos > q_pos - window)


def sp_causal_mask(q_len: int, kv_local: int, q_offset: int, rank: int, device=None) -> torch.Tensor:
    """Causal mask against sp rank `rank`'s KV shard (slots
    [rank * kv_local, (rank + 1) * kv_local)): causality on absolute slot
    positions."""
    kv_pos = rank * kv_local + torch.arange(kv_local, device=device)[None, :]
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    return kv_pos <= q_pos


def sp_sliding_window_mask(
    q_len: int, kv_local: int, q_offset: int, window: int, rank: int, device=None
) -> torch.Tensor:
    """Sliding-window causal mask against sp rank `rank`'s KV shard."""
    kv_pos = rank * kv_local + torch.arange(kv_local, device=device)[None, :]
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    return (kv_pos <= q_pos) & (kv_pos > q_pos - window)


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
    lengths=None,
    sp=None,
) -> Tuple[torch.Tensor, dict]:
    """Write the new k/v into one layer's cache slices (in place) and attend
    over the full cache.  `causal=True` (mask must be None) declares the
    standard predicate, row i attends slots [0, pos + i], and runs the
    kernels; an explicit mask runs the dense op.  `lengths` is a decode
    row's [pos + 1] * B int32 vector when the caller built it once for all
    layers (flash_attend_causal makes it otherwise).

    With `sp` (an SpGroup) `kvs` is the list of the ranks' layer slices,
    `lengths` (decode) the ranks' vectors from `flash_decode.sp_lengths`,
    and the attention is the sequence-parallel composition; `mask`, when
    given, is a list of rank-local [T, S_local] masks."""
    if causal and mask is not None:
        raise ValueError("cached_attend: causal=True requires mask=None")
    if sp is not None:
        return _sp_cached_attend(q, k_new, v_new, kvs, pos, mask, sp, sinks, scale, causal, lengths)
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


def _sp_cached_attend(q, k_new, v_new, ranks, pos, mask, sp, sinks, scale, causal, lengths):
    """cached_attend's sequence-parallel branch (the reference's
    `sp_axis` branch, dnet_tpu/ops/attention.py:111-133).  A causal decode
    row runs the decode kernel's LSE form on every rank, over the cache's
    own codes when it is quantized; anything else (a prompt chunk, or a
    caller's rank-local masks: gpt_oss) the dense sp attention over each
    rank's shard, dequantized to f32 when quantized (`read_kv`)."""
    ranks = write_kv_sp(ranks, k_new, v_new, pos)
    T = q.shape[1]
    S_local = ranks[0]["k"].shape[1]
    if causal and T == 1:
        if lengths is None:
            lengths = sp_lengths(q.shape[0], pos, S_local, sp.devices)
        max_lives = [rank_live(pos, r, S_local) for r in range(sp.size)]
        quant = "k_scale" in ranks[0]
        out = sp_flash_decode_attend(
            q, [c["k"] for c in ranks], [c["v"] for c in ranks], lengths, max_lives, sp, sinks=sinks, scale=scale,
            k_scales=[c["k_scale"] for c in ranks] if quant else None,
            v_scales=[c["v_scale"] for c in ranks] if quant else None,
        )
        return out, ranks
    if causal:
        mask = [sp_causal_mask(T, S_local, pos, r, c["k"].device) for r, c in enumerate(ranks)]
    kv = [read_kv(c) for c in ranks]
    out = sp_decode_attend(q, [k for k, _ in kv], [v for _, v in kv], mask, sp, sinks=sinks, scale=scale)
    return out, ranks


def rotating_cached_attend(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kvs: dict,
    pos: int,
    window: int,
    sinks: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    t_real: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """Sliding-window attention over one layer's ring-buffer cache slices
    (W rows, slot = position % W), written in place.

    A decode row (T = 1) writes the ring FIRST and attends the whole ring
    through the rotating decode kernel, which rebuilds each slot's absolute
    position (`lengths`: the step's [pos + 1] * B vector, made here when
    None).  A prompt chunk attends the ring as it was before the chunk plus
    the chunk's own keys directly (a chunk longer than W would otherwise
    overwrite keys its own earlier queries need), then writes the ring.
    Only the first `t_real` keys of the chunk are real (bucket padding is
    neither attended nor written)."""
    T = q.shape[1]
    W = kvs["k"].shape[1]
    if T == 1:
        kvs = write_kv_rotating(kvs, k_new, v_new, pos, t_real=t_real)
        if lengths is None:
            lengths = decode_lengths(q.shape[0], pos, q.device)
        out = flash_decode_attend(
            q, kvs["k"], kvs["v"], lengths, min(pos + 1, W), scale=scale, sinks=sinks,
            k_scale=kvs.get("k_scale"), v_scale=kvs.get("v_scale"), rotating=True, window=window,
        )
        return out, kvs
    k_prev, v_prev = read_kv(kvs)  # [B, W, KVH, Hd]; a quantized ring in f32
    keys = torch.cat([k_prev, k_new.to(k_prev.dtype)], dim=1)
    vals = torch.cat([v_prev, v_new.to(v_prev.dtype)], dim=1)
    dev = q.device
    i = torch.arange(T, device=dev)[:, None]
    p_abs = pos + i  # the queries' absolute positions [T, 1]
    s = torch.arange(W, device=dev)[None, :]
    # slot s holds the most recent pre-chunk position congruent to s mod W
    a_prev = (pos - 1) - torch.remainder(pos - 1 - s, W)
    m_prev = (a_prev >= 0) & (a_prev > p_abs - window)
    j = torch.arange(T, device=dev)[None, :]  # in-chunk key index
    m_new = (j <= i) & (j > i - window)
    if t_real is not None:
        m_new = m_new & (j < t_real)
    mask = torch.cat([m_prev, m_new], dim=1)  # [T, W + T]
    out = attend(q, keys, vals, mask=mask, sinks=sinks, scale=scale)
    return out, write_kv_rotating(kvs, k_new, v_new, pos, t_real=t_real)


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


@dataclass(frozen=True)
class LaneStep:
    """One decode step's lanes: `lanes` int64 [n] the active lanes,
    `positions` int64 [n] their new rows' positions, `lengths` int32 [B]
    each lane's live length after the write (0 for an idle lane) and
    `max_live` (host int) a bound on every lane's length.  All on the
    cache's device."""

    lanes: torch.Tensor
    positions: torch.Tensor
    lengths: torch.Tensor
    max_live: int


def lane_cached_attend(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    kvs: dict,
    step: LaneStep,
    sinks: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """One decode row per lane (q [B, 1, H, D], k_new/v_new [B, 1, KVH, .])
    over one layer's cache slices [B, S, ...]: the active lanes' rows are
    written at their positions, codes and scales together (a ring, when
    `window` > 0: slot position % S), the other lanes' rows are untouched,
    then lane b attends its [0, lengths[b]) slots (a ring: the last `window`
    positions up to lengths[b] - 1) in one decode-kernel launch."""
    S = kvs["k"].shape[1]
    rotating = window > 0
    slots = torch.remainder(step.positions, S) if rotating else step.positions
    write_kv_rows(kvs, k_new[step.lanes, 0], v_new[step.lanes, 0], step.lanes, slots)
    return flash_decode_attend(
        q.contiguous(), kvs["k"], kvs["v"], step.lengths, min(step.max_live, S), scale=scale, sinks=sinks,
        k_scale=kvs.get("k_scale"), v_scale=kvs.get("v_scale"), rotating=rotating, window=window,
    )
