"""Sequence-parallel attention: the KV sequence is sharded over the ranks
of an sp group (parallel/mesh.py `SpGroup`) and each rank attends its own
shard.

Counterpart of dnet_tpu/ops/ring_attention.py and of
`sp_flash_decode_attend` (dnet_tpu/ops/flash_decode.py:475):

- `sp_decode_attend`: q is replicated to every rank, each rank computes
  dense scores against its shard under a rank-local mask, and one
  log-sum-exp combine (a max and two sums over the ranks,
  `SpGroup.pmax` / `SpGroup.psum`) merges them.  The engine runs a prompt
  chunk through it, as the reference does.
- `sp_flash_decode_attend`: a decode row.  Each rank runs the decode
  kernel's LSE form (`flash_decode_lse`) on its shard, plain or quantized
  (codes dequantized in the kernel's tiles), and the same combine merges
  the unnormalised partials.
- `ring_attend`: full ring attention, KV blocks visiting every rank in
  turn.  No engine path calls it.

Sinks (gpt_oss) fold exactly once, after the combine, never inside a rank;
`scale` overrides the head dim's softmax scale.  Layouts are attend()'s: q
[B, T, H, Hd], each rank's k [B, S_local, KVH, Hd] and v [B, S_local, KVH,
Vd] (Vd = Hd but for MLA's asymmetric cache, deepseek_v2's Vd 128 against
Hd 192); outputs are V-wide.  Lists hold one entry per rank, in rank
order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from dnet_tpu_torch.ops.flash_decode import flash_decode_lse

NEG = -1e30


def _q5(q: torch.Tensor, KVH: int, scale: Optional[float]) -> torch.Tensor:
    """q [B, T, H, Hd] -> [B, KVH, G, T, Hd] f32, scaled."""
    B, T, H, Hd = q.shape
    q5 = q.reshape(B, T, KVH, H // KVH, Hd).permute(0, 2, 3, 1, 4).float()
    return q5 * (Hd**-0.5 if scale is None else scale)


def _block_scores(q5: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q5 [B, KVH, G, Tq, Hd]; k [B, S, KVH, Hd] -> scores [B, KVH, G, Tq, S]."""
    scores = torch.einsum("bkgtd,bskd->bkgts", q5, k.float())
    if mask is not None:
        scores = scores.masked_fill_(~mask.to(scores.device)[None, None, None], NEG)
    return scores


def _unshape(o: torch.Tensor, dtype) -> torch.Tensor:
    """[B, KVH, G, T, Vd] -> [B, T, H, Vd] in dtype."""
    B, KVH, G, T, Vd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, KVH * G, Vd).to(dtype)


def sp_decode_attend(
    q: torch.Tensor,
    k_ranks: Sequence[torch.Tensor],
    v_ranks: Sequence[torch.Tensor],
    valid_ranks: Sequence[torch.Tensor],
    sp,
    sinks: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Distributed flash-decoding with dense per-rank scores: q [B, T, H,
    Hd] on the home device, rank r's shard k [B, S_local, KVH, Hd] / v
    [B, S_local, KVH, Vd] and its
    [T, S_local] boolean mask (True = attend) on its device.  Returns
    [B, T, H, Vd] in q.dtype on the home device.  Every rank's scores
    ([B, KVH, G, T, S_local] f32) live until the global max is known, then
    turn into probabilities in place, and are freed on return."""
    KVH = k_ranks[0].shape[2]
    qs = sp.to_ranks(_q5(q, KVH, scale))
    scores = [_block_scores(qr, k, m) for qr, k, m in zip(qs, k_ranks, valid_ranks)]
    m_glob = sp.pmax([s.amax(dim=-1) for s in scores])  # [B, KVH, G, T]
    sink = None
    if sinks is not None:
        sink = sinks.float().to(m_glob.device).reshape(1, KVH, -1, 1)
        m_glob = torch.maximum(m_glob, sink)
    l_parts, o_parts = [], []
    for s, v, mg in zip(scores, v_ranks, sp.to_ranks(m_glob)):
        p = s.sub_(mg[..., None]).exp_()
        l_parts.append(p.sum(dim=-1))
        o_parts.append(torch.einsum("bkgts,bskd->bkgtd", p, v.float()))
    l_glob = sp.psum(l_parts)
    o_glob = sp.psum(o_parts)
    if sink is not None:
        l_glob = l_glob + torch.exp(sink - m_glob)
    return _unshape(o_glob / torch.clamp(l_glob[..., None], min=1e-30), q.dtype)


def lse_combine(
    parts: Sequence[tuple], sp, sinks: Optional[torch.Tensor], dtype
) -> torch.Tensor:
    """Merge the ranks' unnormalised decode partials (acc [B, 1, H, Vd], m
    and l [B, KVH, G], f32, each on its rank's device) with one log-sum-exp:
    the global max (and the sink) first, then each rank's share rescaled
    and summed.  [B, 1, H, Vd] in dtype on the home device."""
    accs, ms, ls = zip(*parts)
    m_glob = sp.pmax(ms)
    B, KVH, G = m_glob.shape
    sink = None
    if sinks is not None:
        sink = sinks.float().to(m_glob.device).reshape(1, KVH, G)
        m_glob = torch.maximum(m_glob, sink)
    corrs = [torch.exp(m - mg) for m, mg in zip(ms, sp.to_ranks(m_glob))]
    l_glob = sp.psum([l * c for l, c in zip(ls, corrs)])
    o_glob = sp.psum([a * c.reshape(B, 1, KVH * G, 1) for a, c in zip(accs, corrs)])
    if sink is not None:
        l_glob = l_glob + torch.exp(sink - m_glob)
    out = o_glob / torch.clamp(l_glob.reshape(B, 1, KVH * G, 1), min=1e-30)
    return out.to(dtype)


def sp_flash_decode_attend(
    q: torch.Tensor,
    k_ranks: Sequence[torch.Tensor],
    v_ranks: Sequence[torch.Tensor],
    lengths: Sequence[torch.Tensor],
    max_lives: Sequence[int],
    sp,
    sinks: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    k_scales: Optional[Sequence[torch.Tensor]] = None,
    v_scales: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Sequence-parallel decode through the kernel: q [B, 1, H, Hd] on the
    home device; each rank runs flash_decode_lse on its shard with its
    lengths vector (`flash_decode.sp_lengths`) and live bound (and, for a
    quantized cache, its shard's codes with `k_scales` / `v_scales`), and
    lse_combine merges the partials (no sink inside a rank: it folds once,
    there).  [B, 1, H, Vd] in q.dtype on the home device."""
    R = len(k_ranks)
    k_scales = [None] * R if k_scales is None else k_scales
    v_scales = [None] * R if v_scales is None else v_scales
    parts = [
        flash_decode_lse(qr, k, v, ln, ml, scale=scale, k_scale=ks, v_scale=vs)
        for qr, k, v, ln, ml, ks, vs in zip(sp.to_ranks(q), k_ranks, v_ranks, lengths, max_lives, k_scales,
                                            v_scales)
    ]
    return lse_combine(parts, sp, sinks, q.dtype)


def ring_attend(
    q_ranks: Sequence[torch.Tensor],
    k_ranks: Sequence[torch.Tensor],
    v_ranks: Sequence[torch.Tensor],
    q_positions: Sequence[torch.Tensor],
    kv_positions: Sequence[torch.Tensor],
    sp,
    causal: bool = True,
    scale: Optional[float] = None,
) -> List[torch.Tensor]:
    """Full ring attention: rank r's query block q_ranks[r] [B, Tq, H, Hd]
    folds every rank's KV block into one online-softmax accumulator, its
    own block first and then the one from the rank before it, as blocks
    rotate one rank forward per step in the reference's ppermute.
    q_positions[r] [Tq] and kv_positions[r] [S_local] are absolute token
    positions (causal masking follows them).  Returns each rank's output
    [B, Tq, H, Hd] in its q's dtype, on its device."""
    R = sp.size
    KVH = k_ranks[0].shape[2]
    outs = []
    for r, (q, dev) in enumerate(zip(q_ranks, sp.devices)):
        q5 = _q5(q.to(dev), KVH, scale)
        B, _, G, Tq, _ = q5.shape
        m = torch.full((B, KVH, G, Tq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        o = torch.zeros((B, KVH, G, Tq, v_ranks[0].shape[-1]), dtype=torch.float32, device=dev)
        qp = q_positions[r].to(dev)
        for i in range(R):
            src = (r - i) % R  # the block rank r holds after i rotations
            k, v, kp = (t.to(dev) for t in (k_ranks[src], v_ranks[src], kv_positions[src]))
            mask = kp[None, :] <= qp[:, None] if causal else None
            scores = _block_scores(q5, k, mask)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum("bkgts,bskd->bkgtd", p, v.float())
            m = m_new
        outs.append(_unshape(o / torch.clamp(l[..., None], min=1e-30), q.dtype))
    return outs
