"""Causal prefill attention: a hand-written CUDA kernel and its plain version.

Counterpart of dnet_tpu/ops/flash_attention.py.  The kernel
(csrc/flash_prefill.cu) replaces the TPU kernel `_flash_kernel`
(dnet_tpu/ops/flash_attention.py:38): query row i of a chunk attends cache
slots [0, pos + i], with the online-softmax accumulator in f32 and per-head
sink logits folded into the denominator once.  V's head dim may differ
from Q/K's (MLA: deepseek_v2's (Dqk, Dv) = (192, 128)); the kernel is built
for the (Dqk, Dv) pairs in HEAD_DIMS and counts its MLA-width launches
(Dv != Dqk) apart from the others.  The source's header says what bounds
it on the card and how its design answers that.

`flash_prefill` launches the kernel for CUDA tensors (or raises) and runs
`flash_prefill_plain`, the same tile-by-tile fold in PyTorch, for CPU
tensors.  Unlike the TPU gate (`flash_eligible`), there is no dense
fallback on the card: the kernel masks ragged T and S edges itself.
bf16 inputs run on the tensor cores over tiles of head-stacked rows laid
out by `prefill_plan`; f32 inputs keep an exact CUDA-core fold, one head a
block.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch

from dnet_tpu_torch.kernels import build

NEG_INF = -1e30
BK = 64  # keys per tile, in the kernel and in its plain version
# (q/k head dim, v head dim) pairs the kernel is built for
HEAD_DIMS = frozenset({(64, 64), (128, 128), (192, 128)})
# the bf16 kernel's row tiles: 4 warps of one 16-row m-atom, or of two at
# (64, 64) once 128-row tiles still give TC_WIDE_BLOCKS blocks (two an SM)
TC_ROWS, TC_WIDE_ROWS = 64, 128
TC_WIDE_BLOCKS = 2 * 132


@dataclass(frozen=True)
class PrefillPlan:
    """How the bf16 kernel lays a call out (csrc/flash_prefill.cu).  The
    G = H / KVH query heads that share a KV head are stacked into rows,
    packed row r = t * G + g of KV head kvh being query row t of head
    kvh * G + g; a block owns `block_rows` packed rows of one (batch, KV
    head), its 4 warps a quarter each, and block i takes row tile
    row_tiles - 1 - i // (KVH * B): the latest row tiles, which attend the
    most keys, run first."""

    T: int
    G: int
    KVH: int
    B: int
    block_rows: int = TC_ROWS

    @property
    def rows(self) -> int:
        return self.T * self.G

    @property
    def row_tiles(self) -> int:
        return -(-self.rows // self.block_rows)

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.KVH * self.B

    def block(self, i: int) -> Tuple[int, int, int]:
        """(row tile, KV head, batch row) of block i, as the kernel maps it."""
        groups = self.KVH * self.B
        rem = i % groups
        return self.row_tiles - 1 - i // groups, rem % self.KVH, rem // self.KVH

    def tile_rows(self, tile: int) -> range:
        """The packed rows of a row tile (the last one ends at T * G)."""
        return range(tile * self.block_rows, min((tile + 1) * self.block_rows, self.rows))

    def head_row(self, kvh: int, r: int) -> Tuple[int, int]:
        """(query row t, query head h) of packed row r of KV head kvh."""
        return r // self.G, kvh * self.G + r % self.G

    def key_end(self, pos: int, tile: int) -> int:
        """One past the last slot a row tile attends: its key loop's bound
        (and where its zero-filled keys start)."""
        return pos + (self.tile_rows(tile)[-1] // self.G) + 1

    def launch_order(self) -> Iterator[Tuple[int, int, int]]:
        return (self.block(i) for i in range(self.blocks))


def prefill_plan(T: int, H: int, KVH: int, dqk: int, dv: int, B: int = 1) -> PrefillPlan:
    """The bf16 kernel's layout of a [B, T, H, dqk] chunk over KVH KV heads.
    Tiles of 64 packed rows (one 16-row m-atom a warp), or of 128 at
    (64, 64) when those still make TC_WIDE_BLOCKS blocks: on an H100 the
    128-row tile (each K/V fragment feeding two m-atoms) was faster at
    T = 2048 over Llama-3.2-1B's heads and slower at T <= 512, where halving
    the blocks left SMs idle; the wider pairs' registers hold one m-atom a
    warp."""
    if H % KVH:
        raise ValueError(f"{H} query heads are not a multiple of {KVH} KV heads")
    G = H // KVH
    rows = TC_ROWS
    if (dqk, dv) == (64, 64) and -(-T * G // TC_WIDE_ROWS) * KVH * B >= TC_WIDE_BLOCKS:
        rows = TC_WIDE_ROWS
    return PrefillPlan(T=int(T), G=G, KVH=int(KVH), B=int(B), block_rows=rows)


def prefill_smem_bytes(dtype: torch.dtype, dqk: int, dv: int, block_rows: int = TC_ROWS) -> int:
    """Dynamic shared memory of one block of the kernel for `dtype` at
    (dqk, dv), as csrc/flash_prefill.cu lays it out: bf16 Q (block_rows rows)
    and two stages of 64-key K and V tiles, rows padded by 8 values; f32 Q, K,
    P transposed and V, rows padded by 4."""
    if dtype == torch.bfloat16:
        return 2 * (block_rows * (dqk + 8) + 2 * BK * ((dqk + 8) + (dv + 8)))
    return 4 * (dqk * (64 + 4) + dqk * (BK + 4) + BK * (dv + 4) + 64 * (BK + 4))


def flash_attend_causal(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: int,
    scale: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal attention of a chunk against the (preallocated) cache: query
    row i attends slots [0, pos + i].  q [B, T, H, D]; k [B, S, KVH, D];
    v [B, S, KVH, Dv] (Dv may differ from D); out [B, T, H, Dv].

    T == 1 goes to the decode kernel, as on the TPU, over `lengths`
    ([pos + 1] * B int32; made here when None), on quantized codes when
    k_scale/v_scale come with them.  The prefill kernel takes one dtype:
    a cache in another dtype than q (a bf16 cache under an f32 model, or an
    f32 dequantized prefix under a bf16 one) gets the live prefix and q in
    f32, an exact upcast, as the TPU kernel's own f32 softmax does."""
    if q.shape[1] == 1:
        from dnet_tpu_torch.ops.flash_decode import decode_lengths, flash_decode_attend

        if lengths is None:
            lengths = decode_lengths(q.shape[0], pos, q.device)
        return flash_decode_attend(q, k, v, lengths, int(pos) + 1, scale=scale, sinks=sinks,
                                   k_scale=k_scale, v_scale=v_scale)
    if k.dtype != q.dtype:
        end = int(pos) + q.shape[1]
        out = flash_prefill(q.float(), k[:, :end].float(), v[:, :end].float(), pos, scale=scale, sinks=sinks)
        return out.to(q.dtype)
    return flash_prefill(q, k, v, pos, scale=scale, sinks=sinks)


def _check_shapes(q, k, v, pos: int, sinks) -> None:
    B, T, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[-1] != D or v.dim() != 4 or v.shape[:-1] != k.shape[:-1]:
        raise ValueError(f"cache shapes k {tuple(k.shape)} v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    S, KVH = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError(f"{H} query heads are not a multiple of {KVH} KV heads")
    if pos < 0 or pos + T > S:
        raise ValueError(f"chunk [{pos}, {pos + T}) does not fit a cache of {S} slots")
    if sinks is not None and tuple(sinks.shape) != (H,):
        raise ValueError(f"sinks must be [H]={H}, got {tuple(sinks.shape)}")


def flash_prefill(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: int,
    scale: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel wrapper: [B, T, H, Dv] out in q.dtype.  CUDA tensors launch
    the kernel (bf16 or f32, (D, Dv) in HEAD_DIMS) or raise; CPU tensors
    take the plain version."""
    pos = int(pos)
    _check_shapes(q, k, v, pos, sinks)
    B, T, H, D = q.shape
    S, KVH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = D**-0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, pos, scale=scale, sinks=sinks)
    if q.dtype not in build.DTYPE_CODES or (D, Dv) not in HEAD_DIMS:
        raise ValueError(
            f"flash_prefill takes bf16/f32 with (head dim, v head dim) in {sorted(HEAD_DIMS)}, "
            f"got {q.dtype}, {(D, Dv)}"
        )
    if sinks is not None:
        build.check_cuda_tensors("flash_prefill", torch.float32, sinks=sinks)
    build.check_cuda_tensors("flash_prefill", q.dtype, q=q, k=k, v=v)
    out = torch.empty((B, T, H, Dv), dtype=q.dtype, device=q.device)
    rc = _entry()(
        build.DTYPE_CODES[q.dtype], D, Dv, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if sinks is None else sinks.data_ptr(),
        B, T, H, KVH, S, pos, scale, build.current_stream_handle(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed (code {rc})")
    if Dv == D:
        flash_prefill.launches += 1
    else:
        flash_prefill.launches_mla += 1
    return out


# kernel launches since the last reset: at Dv == D, and at MLA widths
flash_prefill.launches = 0
flash_prefill.launches_mla = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
# dtype, head_dim, v_head_dim, q, k, v, o, sinks, B, T, H, KVH, S, pos, scale, stream
_ARGTYPES = (_I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P)


def _entry():
    return build.entry("flash_prefill", "dnet_flash_prefill", _ARGTYPES)


def flash_prefill_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: int,
    scale: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the same fold over 64-key
    tiles, in f32, up to the last slot the chunk's last row attends."""
    B, T, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    Vd = v.shape[-1]
    scale = D**-0.5 if scale is None else float(scale)
    dev = q.device
    qf = q.reshape(B, T, KVH, G, D).float() * scale
    m = torch.full((B, KVH, G, T, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G, T, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, T, Vd), dtype=torch.float32, device=dev)
    q_pos = pos + torch.arange(T, device=dev)[:, None]
    key_end = min(pos + T, S)
    for k0 in range(0, key_end, BK):
        kt = k[:, k0 : k0 + BK].float()
        vt = v[:, k0 : k0 + BK].float()
        scores = torch.einsum("btkgd,bskd->bkgts", qf, kt)
        k_pos = k0 + torch.arange(kt.shape[1], device=dev)[None, :]
        scores = torch.where(k_pos <= q_pos, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgts,bskd->bkgtd", p, vt)
        m = m_new
    if sinks is None:
        sink = torch.full((1, KVH, G, 1, 1), NEG_INF, dtype=torch.float32, device=dev)
    else:
        sink = sinks.float().reshape(1, KVH, G, 1, 1)
    m_fin = torch.maximum(m, sink)
    corr = torch.exp(m - m_fin)
    l_fin = l * corr + torch.exp(sink - m_fin)
    out = acc * corr / torch.clamp(l_fin, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, Vd).to(q.dtype)
