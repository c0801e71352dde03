"""Ragged paged attention: single-token decode that attends the KV block pool
in place through per-slot page tables.  A hand-written CUDA kernel and its
plain version.

Counterpart of dnet_tpu/ops/paged_attention.py.  The kernel
(csrc/paged_attention.cu) replaces the TPU kernel `_paged_kernel`
(dnet_tpu/ops/paged_attention.py:92): slot b's query heads attend pool rows
[0, pos[b]) through its page table, then the current token's row, which the
caller appends to the pool after the call.  The pool is q's dtype, or bf16
under an f32 q (DNET_KV_BITS=16 on an f32 model).  Each slot's loop stops at its
own live length, so table entries past it are never read; `paged_plan`
gives each KV head a budget of blocks, over which the kernel splits every
slot's live tiles in proportion to them (reading the positions on the
device), and the last of a slot's blocks to finish merges their states and
folds the new row, inside the one launch.  Any group size G = H / KVH
runs: a group wider than a block's 8 query rows splits over ceil(G / 8) row
groups of blocks, each with its own budget, and such calls count apart
(`launches_wide`).  A bf16 q over a bf16 pool at head dim 128 with G >= 5
takes the kernel's tensor-core form (16 query rows a block, the decode
kernel's tensor-core tile fold), counted once more on `launches_mma`;
`paged_layout` gives each call's form, rows and row groups.  The source's
header says what bounds it on the card.

`ragged_refusal` says why an engine cannot route decode through the kernel
(None = eligible), with the reference's vocabulary.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from dnet_tpu_torch.kernels import build
from dnet_tpu_torch.ops.flash_decode import (
    BK,
    DECODE_BLOCKS,
    KV_DTYPES,
    MAX_ROWS,
    MAX_SPLITS,
    MIN_TILES_PER_SPLIT,
    MMA_COUNTER,
    MMA_ROWS,
    NEG_INF,
    _merge_scratch,
    row_groups,
    takes_mma,
)

HEAD_DIMS = (64, 128)  # the head dims the paged kernel is built for


def ragged_refusal(model, kv_quant_bits: int = 0) -> Optional[str]:
    """Why this engine cannot route decode through the ragged kernel (None =
    eligible)."""
    if not getattr(model, "supports_paged_attend", False):
        return (
            f"{model.config.model_type} attention stack has no paged-attend "
            "hook (non-llama-family layers stay on dense gather)"
        )
    if kv_quant_bits:
        return (
            f"quantized KV cache (bits={kv_quant_bits}) dequantizes through "
            "the dense gather path"
        )
    return None


def paged_plan(max_live: int, slots: int, kv_heads: int, blocks_per_sm: int = 1) -> int:
    """The paged kernel's blocks per (KV head, row group): `slots` x the
    decode kernel's split count (`decode_plan`'s rule over slots x
    `kv_heads`, the KV heads times their row groups: at most
    MAX_SPLITS, no more than gives the longest slot MIN_TILES_PER_SPLIT
    tiles a split, and one wave: DECODE_BLOCKS x `blocks_per_sm`, the
    instantiation's blocks an SM).  The kernel splits each slot's live
    tiles over them in proportion to its tiles, so ragged slots share the
    budget by their work."""
    n_tiles = -(-max(int(max_live), 1) // BK)
    per_slot = min(MAX_SPLITS, -(-n_tiles // MIN_TILES_PER_SPLIT),
                   DECODE_BLOCKS * int(blocks_per_sm) // max(int(slots) * int(kv_heads), 1))
    return max(1, per_slot) * int(slots)


def paged_layout(q_dtype, kv_dtype, head_dim: int, group: int) -> tuple:
    """(tensor-core form?, query rows a block, row groups a KV head) of a
    paged call: a bf16 q over a bf16 pool at head dim 128 with group >= 5
    on the tensor cores (`takes_mma`, as the decode kernel), every other
    call on the CUDA cores with the group rounded up to 1, 4 or 8 rows a
    block (at head dim 128 too, unlike the decode kernel: there 8 rows
    fold 16 lanes a key without spilling, and an f32 call at G = 8 and 16
    ran faster that way than in row groups of 4 in a probe on the card)."""
    mma = takes_mma(q_dtype, kv_dtype, 0, head_dim, head_dim, group)
    rows = MMA_ROWS if mma else 1 if group == 1 else 4 if group <= 4 else MAX_ROWS
    return mma, rows, row_groups(group, rows)


def _check_shapes(q, k_pool, v_pool, tables, pos, k_new, v_new) -> None:
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"paged_attend takes one query row, got T={T}")
    if k_pool.dim() != 4 or k_pool.shape[-1] != D or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pool shapes k {tuple(k_pool.shape)} v {tuple(v_pool.shape)} do not match q {tuple(q.shape)}"
        )
    KVH = k_pool.shape[2]
    if H % KVH:
        raise ValueError(f"{H} query heads are not a multiple of {KVH} KV heads")
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be [B={B}, nb], got {tuple(tables.shape)}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be [B={B}], got {tuple(pos.shape)}")
    if tuple(k_new.shape) != (B, KVH, D) or v_new.shape != k_new.shape:
        raise ValueError(
            f"new rows k {tuple(k_new.shape)} v {tuple(v_new.shape)} must be [B, KVH, D]=({B}, {KVH}, {D})"
        )


def paged_attend(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,
    pos: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    scale: Optional[float] = None,
    max_live: Optional[int] = None,
) -> torch.Tensor:
    """Kernel wrapper.  q [B, 1, H, D]; k_pool/v_pool [N_blocks, bt, KVH, D]
    (one layer's pool, in q's dtype or bf16 under an f32 q); tables [B, nb]
    int32 (entries past a slot's live blocks are never read); pos [B] int32
    live pool rows per slot; k_new/v_new [B, KVH, D] the current token's
    rows in q's dtype, attended at position pos.  Returns [B, 1, H, D] in
    q.dtype.

    `max_live` is the caller's upper bound on every pos (the host knows it
    without reading the device); it plans the split (`paged_plan`) and
    defaults to the tables' capacity.  A low bound costs balance, not rows:
    the kernel splits each slot's live tiles as the positions on the device
    give them.  CUDA tensors launch the kernel (bf16 or f32, head dim 64 or 128,
    any H/KVH) or raise; CPU tensors take the plain version."""
    _check_shapes(q, k_pool, v_pool, tables, pos, k_new, v_new)
    B, _, H, D = q.shape
    bt, KVH = k_pool.shape[1], k_pool.shape[2]
    nb = tables.shape[1]
    scale = D**-0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return paged_attend_plain(q, k_pool, v_pool, tables, pos, k_new, v_new, scale=scale)
    if q.dtype not in build.DTYPE_CODES or D not in HEAD_DIMS:
        raise ValueError(f"paged_attend takes bf16/f32 and head dim 64/128; got {q.dtype}, {D}")
    if k_pool.dtype not in KV_DTYPES[q.dtype]:
        raise ValueError(f"paged_attend reads a {q.dtype} q over a {KV_DTYPES[q.dtype]} pool, got {k_pool.dtype}")
    build.check_cuda_tensors("paged_attend", q.dtype, q=q, k_new=k_new, v_new=v_new)
    build.check_cuda_tensors("paged_attend", k_pool.dtype, device=q.device, k_pool=k_pool, v_pool=v_pool)
    build.check_cuda_tensors("paged_attend", torch.int32, tables=tables, pos=pos)
    live_bound = nb * bt if max_live is None else min(int(max_live), nb * bt)
    G = H // KVH
    mma, rows, rg = paged_layout(q.dtype, k_pool.dtype, D, G)
    groups = KVH * rg
    nx = paged_plan(live_bound, B, groups, blocks_per_sm(q.dtype, k_pool.dtype, D, H, KVH, rows))
    out = torch.empty_like(q)
    stream = build.current_stream_handle(q.device)
    # the merge scratch holds nx states a (KV head, row group): B x ceil(nx / B) >= nx
    rc = _entry()(
        build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_pool.dtype], D, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(),
        *_merge_scratch(q.device, stream, -(-nx // B), B, groups, rows, D),
        B, H, KVH, nb, bt, nx, rows, scale, stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed (code {rc})")
    if G > MAX_ROWS:
        build.count_launch(paged_attend, "launches_wide")
    else:
        build.count_launch(paged_attend)
    if mma:
        build.count_launch(paged_attend, MMA_COUNTER)
    return out


# kernel launches since the last reset: G <= 8, wider groups, and the
# tensor-core form's (beside its group's counter)
paged_attend.launches = paged_attend.launches_wide = 0
setattr(paged_attend, MMA_COUNTER, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
# dtype, kv_dtype, head_dim, q, k_pool, v_pool, tables, pos, k_new, v_new, o,
# part, tickets, B, H, KVH, nb, bt, nx, rows, scale, stream
_ARGTYPES = (
    _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P,
)


def _entry():
    return build.entry("paged_attention", "dnet_paged_attention", _ARGTYPES)


def _query(what: int, dtype, kv_dtype, head_dim: int, H: int, KVH: int, rows: Optional[int]) -> int:
    if rows is None:
        rows = paged_layout(dtype, kv_dtype, head_dim, H // KVH)[1]
    return build.entry("paged_attention", "dnet_paged_attention_query", (_I,) * 7)(
        what, build.DTYPE_CODES[dtype], build.DTYPE_CODES[kv_dtype], head_dim, H, KVH, rows)


def kernel_smem_bytes(dtype, kv_dtype, head_dim: int, H: int, KVH: int, rows: Optional[int] = None) -> int:
    """Dynamic shared memory (bytes) of the kernel instantiation a call with
    these dtypes, head dim, grouping and rows a block (`paged_layout`'s by
    default) launches (builds the kernel; -1 for one it was not built for)."""
    return _query(1, dtype, kv_dtype, head_dim, H, KVH, rows)


@functools.lru_cache(maxsize=None)
def blocks_per_sm(dtype, kv_dtype, head_dim: int, H: int, KVH: int, rows: Optional[int] = None) -> int:
    """Blocks an SM of the kernel instantiation a call with these dtypes,
    head dim, grouping and rows a block launches: 2 where its fold fits 128
    registers a thread, else 1 (builds the kernel)."""
    return _query(2, dtype, kv_dtype, head_dim, H, KVH, rows)


def paged_attend_plain(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,
    pos: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in f32: per slot, the
    online-softmax fold over its live rows (gathered through its table, in
    64-key tiles), then the new row folded last."""
    B, _, H, D = q.shape
    bt, KVH = k_pool.shape[1], k_pool.shape[2]
    G = H // KVH
    Vd = v_pool.shape[-1]
    scale = D**-0.5 if scale is None else float(scale)
    dev = q.device
    outs = []
    for b, live in enumerate(pos.tolist()):
        qf = q[b, 0].reshape(KVH, G, D).float() * scale
        m = torch.full((KVH, G, 1), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((KVH, G, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((KVH, G, Vd), dtype=torch.float32, device=dev)
        if live:
            ids = tables[b, : -(-live // bt)].long()  # the live blocks only
            kb = k_pool[ids].reshape(-1, KVH, D)[:live]
            vb = v_pool[ids].reshape(-1, KVH, Vd)[:live]
            for k0 in range(0, live, BK):
                scores = torch.einsum("kgd,skd->kgs", qf, kb[k0 : k0 + BK].float())
                m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
                p = torch.exp(scores - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1, keepdim=True)
                acc = acc * corr + torch.einsum("kgs,skd->kgd", p, vb[k0 : k0 + BK].float())
                m = m_new
        s_new = torch.einsum("kgd,kd->kg", qf, k_new[b].float())[..., None]
        m_fin = torch.maximum(m, s_new)
        corr = torch.exp(m - m_fin)
        p_new = torch.exp(s_new - m_fin)
        l = l * corr + p_new
        acc = acc * corr + p_new * v_new[b].float()[:, None, :]
        outs.append(acc / torch.clamp(l, min=1e-30))
    return torch.stack(outs).reshape(B, 1, H, Vd).to(q.dtype)
