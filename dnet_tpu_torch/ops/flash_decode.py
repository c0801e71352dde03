"""Single-token decode attention: a hand-written CUDA kernel and its plain
version.

Counterpart of dnet_tpu/ops/flash_decode.py.  The kernel
(csrc/flash_decode.cu) replaces the TPU kernel `_decode_kernel`
(dnet_tpu/ops/flash_decode.py:50) in its plain variant, its `qbits` 8/4
variant and its `rotating` variant (with_lse=False, offset=0): one query
row per head against the preallocated cache, sharing each K/V tile across
the G query heads of a KV group.  The cache is q's dtype (or bf16 under an f32
q: DNET_KV_BITS=16 on an f32 model), or quantized (int8 codes, or int4 nibbles packed in pairs along the head dim, with f32 scales
per slot and KV head; core/kvcache.py) and then dequantized tile by tile in
on-chip memory.  Each lane b of the batch attends its own live slots
[0, lengths[b]) (an int32 [B] vector on the device; 0 = an idle lane, whose
output is zeros): the single-sequence engine passes [pos + 1], dense
batched slots each lane's position + 1.  Each lane's live tiles are split
across blocks (flash-decoding; `decode_plan` picks how many), and the last
of them to finish merges their states inside the one launch.  V's head dim
may differ from Q/K's (MLA: deepseek_v2's (Dqk, Dv) = (192, 128) with
G = 1), in every cache form but
the rotating one; launches at those widths count apart (COUNTERS).  Any
group size G = H / KVH runs: a block holds `query_rows` of a group's query
heads (1, 4 or 8), and a larger group splits over ceil(G / rows) row groups
of blocks in the same launch (G = 16: Qwen3-235B-A22B's 64 / 4 heads);
every call with G > 8 counts under its own counter,
`launches_wide`, whatever its form.  A bf16 q over a bf16 cache at head
dim 128 with G >= 5 takes the kernel's tensor-core form instead
(`takes_mma`: 16 query rows a block, mma.sync scores and P V, P as two
bf16 terms), counted once more on `launches_mma`; `decode_layout` gives
each call's form, rows and row groups, and a CUDA tensor launches exactly
that form or raises.  The source's header says what bounds it on the
card.

`rotating=True` is gpt_oss's sliding-window ring buffer: the cache holds
W slots written before the call (core/kvcache.py `write_kv_rotating`),
lane b's query sits at pos = lengths[b] - 1 (lengths may exceed W), its
live slots are [0, min(lengths[b], W)), slot s holds absolute position
pos - ((pos - s) mod W), and only keys inside the last `window` positions
are attended.  Every cache form (bf16, f32, q8, q4) takes it.

`flash_decode_lse` is the `with_lse` (sequence-parallel) form: one sp
rank's UNNORMALISED partials (acc relative to the rank's max m, the
softmax denominator l), which ops/ring_attention.py combines across ranks
with one log-sum-exp.  It takes every cache form but the rotating one
(plain, q8, q4) at every (Dqk, Dv) pair, MLA's included, and counts each
apart (COUNTERS).  Over codes it dequantizes tile by tile where the
reference dequantizes the rank's whole shard to f32 first (`read_kv`):
both compute code * scale in f32.  A rank's shard offset lives in its lengths
vector (`sp_lengths`): the reference masks by an offset scalar, the port
by the live slot count clamp(pos + 1 - offset, 0, S_local), so a rank
wholly past pos has length 0 and emits m = NEG_INF, l = 0, acc = 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dnet_tpu_torch.core.kvcache import read_kv
from dnet_tpu_torch.kernels import build

NEG_INF = -1e30
BK = 64  # keys per tile, in the kernel and in its plain version
# (q/k head dim, v head dim) pairs the kernel is built for
HEAD_DIMS = frozenset({(64, 64), (128, 128), (192, 128)})
# query heads per KV head a CUDA-core block holds (larger groups split over
# blocks), and the group past which a call counts as wide (WIDE_COUNTER)
MAX_ROWS = 8
# the decode (and paged) kernel's blocks sharing one (lane, KV head), each
# with some depth, and its blocks a call: one wave, a block an SM of a
# 132-SM card
MAX_SPLITS = 16
MIN_TILES_PER_SPLIT = 2
DECODE_BLOCKS = 132
# the cache's code dtype -> the kernel's variant (the reference picks it the
# same way from the cache dtype, dnet_tpu/ops/flash_decode.py:444-446)
QBITS = {torch.int8: 8, torch.uint8: 4}
# the decode kernel's launch counter per form, (qbits, rotating, Dv != D,
# with_lse) -> attribute of flash_decode_attend (flash_decode_lse counts
# there too: one kernel source, one holder of its counters)
COUNTERS = {
    (0, False, False, False): "launches", (8, False, False, False): "launches_q8",
    (4, False, False, False): "launches_q4", (0, True, False, False): "launches_rot",
    (8, True, False, False): "launches_rot_q8", (4, True, False, False): "launches_rot_q4",
    (0, False, True, False): "launches_mla", (8, False, True, False): "launches_mla_q8",
    (4, False, True, False): "launches_mla_q4", (0, False, False, True): "launches_lse",
    (8, False, False, True): "launches_lse_q8", (4, False, False, True): "launches_lse_q4",
    (0, False, True, True): "launches_lse_mla", (8, False, True, True): "launches_lse_mla_q8",
    (4, False, True, True): "launches_lse_mla_q4",
}
# every form's launches with more query heads a KV head than a block holds
WIDE_COUNTER = "launches_wide"
# an unquantized cache's dtypes the kernel reads under each q dtype
KV_DTYPES = {torch.float32: (torch.float32, torch.bfloat16), torch.bfloat16: (torch.bfloat16,)}


def decode_plan(max_live: int, n_blocks_per_split: int) -> int:
    """The decode kernel's split count: the blocks sharing each (lane, KV
    head, row group), where `n_blocks_per_split` = KV heads x row groups x
    lanes.  At most
    MAX_SPLITS, at least one, and no more than gives the longest lane
    MIN_TILES_PER_SPLIT tiles a split or the call more than DECODE_BLOCKS
    blocks.  Each lane splits its own live tiles over them in the kernel."""
    n_tiles = -(-max(int(max_live), 1) // BK)
    return max(1, min(MAX_SPLITS, -(-n_tiles // MIN_TILES_PER_SPLIT), DECODE_BLOCKS // n_blocks_per_split))


# the tensor-core forms' query rows a block (mma.sync's m) and the
# smallest group they take: a bf16 q over a bf16 cache at head dim 128
MMA_ROWS = 16
MMA_MIN_GROUP = 5
MMA_HEAD_DIM = 128
MMA_COUNTER = "launches_mma"
# the tensor-core forms' tolerances against the f32 plain version on the
# same bf16 inputs (max abs error): outputs kept in f32 (the LSE partials:
# m, l relative to itself, acc / l) and outputs rounded to bf16
# (normalised decode, paged).  tests/test_torch_decode_mma.py holds its
# emulation of their numerics to the reference's kernels within them, and
# chip_smoke.py holds the kernels to them on the card.
MMA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def query_rows(group: int, head_dim: int) -> int:
    """The query rows a CUDA-core decode block holds (its GP: 1, 4 or 8) for
    `group` query heads per KV head at q/k head dim `head_dim`: the group's
    whole size rounded up to 1, 4 or 8 where one block holds it, else 8 a
    block (`row_groups` blocks a KV head); at head dim 128 never more than
    4 (the GP = 8 instantiation spills there and is not built)."""
    if group == 1:
        return 1
    if group <= 4 or head_dim == MMA_HEAD_DIM:
        return 4
    return MAX_ROWS


def row_groups(group: int, rows: int) -> int:
    """The blocks a (lane, split, KV head) takes: ceil(group / rows)."""
    return -(-group // rows)


def takes_mma(q_dtype, kv_dtype, qbits: int, head_dim: int, v_head_dim: int, group: int,
              rotating: bool = False) -> bool:
    """Whether a call takes the kernel's tensor-core form: a bf16 q over a
    bf16 cache (no codes) at (128, 128), group >= MMA_MIN_GROUP, not
    rotating.  Every other call takes the CUDA-core form."""
    return (q_dtype == torch.bfloat16 and kv_dtype == torch.bfloat16 and not qbits and not rotating
            and head_dim == v_head_dim == MMA_HEAD_DIM and group >= MMA_MIN_GROUP)


def decode_layout(q_dtype, kv_dtype, qbits: int, head_dim: int, v_head_dim: int, group: int,
                  rotating: bool = False) -> tuple:
    """(tensor-core form?, query rows a block, row groups a KV head) of a
    decode call: MMA_ROWS rows on the tensor cores, `query_rows` on the
    CUDA cores."""
    mma = takes_mma(q_dtype, kv_dtype, qbits, head_dim, v_head_dim, group, rotating)
    rows = MMA_ROWS if mma else query_rows(group, head_dim)
    return mma, rows, row_groups(group, rows)


# per (device, stream): the decode and paged kernels' merge scratch, the
# blocks' states (f32) and one ticket per (lane, KV head, row group)
# (int32; the merging block returns it to 0, so a stream's calls share them)
_MERGE_SCRATCH: dict = {}


def _merge_scratch(device: torch.device, stream: int, n_split: int, B: int, groups: int, rows: int,
                   Dv: int) -> tuple:
    """(part pointer, tickets pointer) for a call with n_split > 1 on
    `stream` (`groups` = KV heads x row groups, `rows` query rows a block),
    grown as a call needs more; (None, None) for one split."""
    if n_split == 1:
        return None, None
    n_part, n_pairs = B * groups * n_split * rows * (2 + Dv), B * groups
    part, tickets = _MERGE_SCRATCH.get((device, stream), (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_pairs:
        tickets = torch.zeros(n_pairs, dtype=torch.int32, device=device)
    _MERGE_SCRATCH[(device, stream)] = (part, tickets)
    return part.data_ptr(), tickets.data_ptr()


def decode_lengths(batch: int, pos: int, device) -> torch.Tensor:
    """The lengths vector of a batch whose lanes all sit at `pos`: [pos + 1]
    * batch, int32 on `device` (a fill, no host-to-device copy)."""
    return torch.full((batch,), int(pos) + 1, dtype=torch.int32, device=device)


def _cache_form(name, q, k, v, lengths, max_live, k_scale, v_scale):
    """Check a decode call's shapes, which the kernel and its plain version
    share; returns (qbits, S, KVH, Dv, max_live) with Dv v's unpacked
    width."""
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"{name} takes one query row, got T={T}")
    qbits = 0 if k_scale is None else QBITS.get(k.dtype, -1)
    if qbits < 0:
        raise ValueError(f"quantized cache codes must be int8 or uint8, got {k.dtype}")
    Ds = D // 2 if qbits == 4 else D
    if k.dim() != 4 or k.shape[0] != B or k.shape[-1] != Ds or v.dim() != 4 or v.shape[:-1] != k.shape[:-1]:
        raise ValueError(f"cache shapes k {tuple(k.shape)} v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    S, KVH = k.shape[1], k.shape[2]
    Dv = v.shape[-1] * 2 if qbits == 4 else v.shape[-1]
    if qbits and (
        v_scale is None or tuple(k_scale.shape) != (B, S, KVH, 1) or v_scale.shape != k_scale.shape
    ):
        raise ValueError(f"scales must both be [B, S, KVH, 1]={(B, S, KVH, 1)}")
    if H % KVH:
        raise ValueError(f"{H} query heads are not a multiple of {KVH} KV heads")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B]={B}, got {tuple(lengths.shape)}")
    max_live = int(max_live)
    if not 0 <= max_live <= S:
        raise ValueError(f"max_live {max_live} outside a cache of {S} slots")
    return qbits, S, KVH, Dv, max_live


def _check_launch(name, q, k, v, lengths, qbits, Dv, k_scale, v_scale, rotating=False):
    """Raise for a CUDA call the kernel was not built for; check every
    tensor's device, dtype and layout."""
    H, D, KVH = q.shape[2], q.shape[3], k.shape[2]
    if q.dtype not in build.DTYPE_CODES or (D, Dv) not in HEAD_DIMS or (rotating and Dv != D):
        raise ValueError(
            f"{name} takes bf16/f32 and (head dim, v head dim) in {sorted(HEAD_DIMS)} (equal when "
            f"rotating); got {q.dtype}, {(D, Dv)}"
        )
    if not qbits and k.dtype not in KV_DTYPES[q.dtype]:
        raise ValueError(f"{name} reads a {q.dtype} q over a {KV_DTYPES[q.dtype]} cache, got {k.dtype}")
    dev = q.device
    build.check_cuda_tensors(name, q.dtype, q=q)
    build.check_cuda_tensors(name, k.dtype, device=dev, k=k, v=v)
    build.check_cuda_tensors(name, torch.int32, device=dev, lengths=lengths)
    if qbits:
        build.check_cuda_tensors(name, torch.float32, device=dev, k_scale=k_scale, v_scale=v_scale)


def flash_decode_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    max_live: int,
    scale: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    rotating: bool = False,
    window: int = 0,
) -> torch.Tensor:
    """Kernel wrapper: lane b of q [B, 1, H, D] attends cache slots
    [0, lengths[b]) of k/v; [B, 1, H, Dv] out in q.dtype.  k is
    [B, S, KVH, D] and v [B, S, KVH, Dv] in q's dtype (or bf16 under an f32
    q), or with k_scale/v_scale ([B, S, KVH, 1] f32) int8 codes of those
    widths or packed-int4 uint8 codes of half of them.
    `max_live` (host int) bounds every lane's live slots: the split plan
    covers it.  `rotating`: k/v are a ring of S slots, lengths[b] is the
    query's position + 1 (it may exceed S; the live slots are
    min(lengths[b], S)), and only the last `window` positions (0 < window
    <= S) are attended.
    CUDA tensors launch the kernel (bf16 or f32 q, (D, Dv) in HEAD_DIMS,
    Dv == D when rotating, any H/KVH) or raise; CPU tensors take the plain
    version."""
    qbits, S, KVH, Dv, max_live = _cache_form("flash_decode", q, k, v, lengths, max_live, k_scale, v_scale)
    B, _, H, D = q.shape
    if sinks is not None and tuple(sinks.shape) != (H,):
        raise ValueError(f"sinks must be [H]={H}, got {tuple(sinks.shape)}")
    window = int(window)
    if rotating and not 0 < window <= S:
        raise ValueError(f"a rotating cache of {S} slots needs 0 < window <= {S}, got {window}")
    scale = D**-0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, scale=scale, sinks=sinks, k_scale=k_scale,
                                  v_scale=v_scale, max_live=max_live, rotating=rotating, window=window)
    _check_launch("flash_decode", q, k, v, lengths, qbits, Dv, k_scale, v_scale, rotating)
    if sinks is not None:
        build.check_cuda_tensors("flash_decode", torch.float32, device=q.device, sinks=sinks)
    out = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=q.device)
    mma, rows, rg = decode_layout(q.dtype, k.dtype, qbits, D, Dv, H // KVH, rotating)
    groups = KVH * rg  # (KV head, row group) pairs a lane
    n_split = decode_plan(max_live, groups * B)
    stream = build.current_stream_handle(q.device)
    rc = _entry()(
        build.DTYPE_CODES[q.dtype], build.DTYPE_CODES.get(k.dtype, -1), qbits, D, Dv,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if qbits else None, v_scale.data_ptr() if qbits else None,
        out.data_ptr(), None if sinks is None else sinks.data_ptr(), lengths.data_ptr(),
        *_merge_scratch(q.device, stream, n_split, B, groups, rows, Dv),
        B, H, KVH, S, n_split, rows, scale, int(bool(rotating)), window, stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed (code {rc})")
    _count(H // KVH, COUNTERS[qbits, bool(rotating), Dv != D, False], mma)
    return out


def _count(group: int, counter: str, mma: bool) -> None:
    """One launch on `counter`, or on WIDE_COUNTER for a group of more than
    MAX_ROWS heads, and one more on MMA_COUNTER for the tensor-core form."""
    if group > MAX_ROWS:
        counter = WIDE_COUNTER
    for c in (counter, MMA_COUNTER) if mma else (counter,):
        build.count_launch(flash_decode_attend, c)


# kernel launches since the last reset, per variant (COUNTERS, WIDE_COUNTER)
# and of the tensor-core form (MMA_COUNTER, beside its variant's)
for _counter in (*COUNTERS.values(), WIDE_COUNTER, MMA_COUNTER):
    setattr(flash_decode_attend, _counter, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
# dtype, kv_dtype, qbits, head_dim, v_head_dim, q, k, v, k_scale, v_scale,
# o, sinks, lengths, part, tickets, B, H, KVH, S, n_split, rows, scale,
# rotating, window, stream
_ARGTYPES = (_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
             _I, _I, _P)
# dtype, kv_dtype, qbits, head_dim, v_head_dim, q, k, v, k_scale, v_scale,
# o, m, l, lengths, part, tickets, B, H, KVH, S, n_split, rows, scale, stream
_LSE_ARGTYPES = (_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                 ctypes.c_float, _P)
# dtype, kv_dtype, qbits, head_dim, v_head_dim, H, KVH, rows, rotating
_SMEM_ARGTYPES = (_I,) * 9


def _entry():
    return build.entry("flash_decode", "dnet_flash_decode", _ARGTYPES)


def kernel_smem_bytes(dtype, kv_dtype, qbits: int, head_dim: int, v_head_dim: int, H: int, KVH: int,
                      rotating: bool = False) -> int:
    """Dynamic shared memory (bytes) of the kernel instantiation a call with
    these dtypes, cache form, widths and grouping launches (builds the
    kernel; -1 for one it was not built for)."""
    rows = decode_layout(dtype, kv_dtype, qbits, head_dim, v_head_dim, H // KVH, rotating)[1]
    return build.entry("flash_decode", "dnet_flash_decode_smem", _SMEM_ARGTYPES)(
        build.DTYPE_CODES[dtype], build.DTYPE_CODES.get(kv_dtype, -1), qbits, head_dim, v_head_dim, H, KVH,
        rows, int(bool(rotating)))


def rank_live(pos: int, rank: int, s_local: int) -> int:
    """Live slots of sp rank `rank`'s shard, slots [rank * s_local,
    (rank + 1) * s_local), for a query at `pos`: 0 when the shard lies
    wholly past pos."""
    return min(max(int(pos) + 1 - rank * s_local, 0), s_local)


def sp_lengths(batch: int, pos: int, s_local: int, devices) -> list:
    """Each sp rank's lengths vector for a decode row at `pos`
    ([rank_live] * batch, int32 on the rank's device): made once per decode
    step, not once per layer."""
    return [decode_lengths(batch, rank_live(pos, r, s_local) - 1, d) for r, d in enumerate(devices)]


def flash_decode_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    max_live: int,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> tuple:
    """Kernel wrapper, the LSE form: lane b of q [B, 1, H, D] attends slots
    [0, lengths[b]) of one sp rank's cache k [B, S, KVH, D] / v
    [B, S, KVH, Dv] (q's dtype, or bf16 under an f32 q; or with
    k_scale/v_scale int8 / packed-int4 codes, as flash_decode_attend takes
    them) and returns the rank's UNNORMALISED partials (acc [B, 1, H, Dv],
    m [B, KVH, G], l [B, KVH, G], all f32): acc and l relative to the
    rank's max m; no sink, no division (the cross-rank combine,
    ops/ring_attention.py, does both once).  A lane of length 0 gives
    (0, NEG_INF, 0).  `max_live` (host int) bounds every lane's length.
    CUDA tensors launch the kernel ((D, Dv) in HEAD_DIMS, any H/KVH) or
    raise; CPU tensors take the plain version."""
    qbits, S, KVH, Dv, max_live = _cache_form("flash_decode_lse", q, k, v, lengths, max_live, k_scale, v_scale)
    B, _, H, D = q.shape
    scale = D**-0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_decode_lse_plain(q, k, v, lengths, scale=scale, max_live=max_live, k_scale=k_scale,
                                      v_scale=v_scale)
    _check_launch("flash_decode_lse", q, k, v, lengths, qbits, Dv, k_scale, v_scale)
    dev = q.device
    G = H // KVH
    acc = torch.empty((B, 1, H, Dv), dtype=torch.float32, device=dev)
    m = torch.empty((B, KVH, G), dtype=torch.float32, device=dev)
    l = torch.empty((B, KVH, G), dtype=torch.float32, device=dev)
    mma, rows, rg = decode_layout(q.dtype, k.dtype, qbits, D, Dv, G)
    groups = KVH * rg
    n_split = decode_plan(max_live, groups * B)
    stream = build.current_stream_handle(dev)
    rc = build.entry("flash_decode", "dnet_flash_decode_lse", _LSE_ARGTYPES)(
        build.DTYPE_CODES[q.dtype], build.DTYPE_CODES.get(k.dtype, -1), qbits, D, Dv,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if qbits else None, v_scale.data_ptr() if qbits else None,
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), lengths.data_ptr(),
        *_merge_scratch(dev, stream, n_split, B, groups, rows, Dv),
        B, H, KVH, S, n_split, rows, scale, stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_decode_lse kernel launch failed (code {rc})")
    _count(G, COUNTERS[qbits, False, Dv != D, True], mma)
    return acc, m, l


def flash_decode_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    scale: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    max_live: Optional[int] = None,
    rotating: bool = False,
    window: int = 0,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the online-softmax fold over
    64-key tiles dequantized to f32, sharing the tiles across each group.
    A tile past a lane's live slots leaves that lane's state untouched, so
    an idle lane (length 0) gives zeros.  `max_live` bounds the live slots
    (read from `lengths` when None).  `rotating`: the ring's mask as the
    kernel's (flash_decode_attend)."""
    B, _, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    m, l, acc = _fold_tiles(q, k, v, lengths, scale, k_scale, v_scale, max_live, rotating, window)
    dev = q.device
    if sinks is None:
        sink = torch.full((1, KVH, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    else:
        sink = sinks.float().reshape(1, KVH, G, 1)
    m_fin = torch.maximum(m, sink)
    corr = torch.exp(m - m_fin)
    l_fin = l * corr + torch.exp(sink - m_fin)
    out = acc * corr / torch.clamp(l_fin, min=1e-30)
    return out.reshape(B, 1, H, acc.shape[-1]).to(q.dtype)


def flash_decode_lse_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    scale: Optional[float] = None,
    max_live: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> tuple:
    """The LSE form's function in plain PyTorch: flash_decode_plain's tile
    fold (codes dequantized tile by tile) without its final normalisation
    (the counterpart of the reference's `_decode_emulate(...,
    with_lse=True)`): (acc [B, 1, H, Dv], m [B, KVH, G], l [B, KVH, G]),
    f32."""
    B, _, H, _ = q.shape
    m, l, acc = _fold_tiles(q, k, v, lengths, scale, k_scale, v_scale, max_live, False, 0)
    return acc.reshape(B, 1, H, acc.shape[-1]), m[..., 0], l[..., 0]


def _fold_tiles(q, k, v, lengths, scale, k_scale, v_scale, max_live, rotating, window):
    """The online-softmax fold over 64-key tiles that both plain versions
    share: (m, l, acc) per lane, KV head and query head of its group,
    [B, KVH, G, 1] twice and [B, KVH, G, Dv], f32.  A tile past a lane's
    live slots leaves that lane's state untouched: an idle lane keeps
    (NEG_INF, 0, 0)."""
    B, _, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    Dv = v.shape[-1] * 2 if k_scale is not None and v.dtype == torch.uint8 else v.shape[-1]
    scale = D**-0.5 if scale is None else float(scale)
    dev = q.device
    pos = lengths.to(device=dev, dtype=torch.int64) - 1  # the queries' positions (rotating)
    lengths = (pos + 1).clamp(max=S)  # live slots per lane
    live = int(lengths.max()) if max_live is None else min(int(max_live), S)
    qf = q[:, 0].reshape(B, KVH, G, D).float() * scale
    m = torch.full((B, KVH, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, Dv), dtype=torch.float32, device=dev)
    for k0 in range(0, live, BK):
        k1 = min(k0 + BK, live)
        slot = (k0 + torch.arange(k1 - k0, device=dev))[None, :]
        valid = slot < lengths[:, None]  # [B, s]
        if rotating:
            # the slot holds the most recent position <= pos congruent to it mod S
            k_abs = pos[:, None] - torch.remainder(pos[:, None] - slot, S)
            valid = valid & (k_abs >= 0) & (k_abs > pos[:, None] - window)
        # rows past a lane's length are never used, whatever they hold
        tile = {"k": k[:, k0:k1], "v": v[:, k0:k1]}
        if k_scale is not None:
            tile.update(k_scale=k_scale[:, k0:k1], v_scale=v_scale[:, k0:k1])
        rows = valid[:, :, None, None]
        kt, vt = (torch.where(rows, t.float(), 0.0) for t in read_kv(tile))
        scores = torch.einsum("bkgd,bskd->bkgs", qf, kt)
        scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        corr = torch.exp(m - m_new)
        tile_live = (lengths > k0)[:, None, None, None]
        l = torch.where(tile_live, l * corr + p.sum(dim=-1, keepdim=True), l)
        acc = torch.where(tile_live, acc * corr + torch.einsum("bkgs,bskd->bkgd", p, vt), acc)
        m = torch.where(tile_live, m_new, m)
    return m, l, acc
