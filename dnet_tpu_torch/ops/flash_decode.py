"""Single-token decode attention: a hand-written CUDA kernel and its plain
version.

Counterpart of dnet_tpu/ops/flash_decode.py.  The kernel
(csrc/flash_decode.cu) replaces the TPU kernel `_decode_kernel`
(dnet_tpu/ops/flash_decode.py:50) in its plain variant (qbits=0,
rotating=False, with_lse=False, offset=0): one query row per head against
the dense preallocated cache, reading only the live slots [0, pos] and
sharing each K/V tile across the G query heads of a KV group.  The live
range is split across blocks (flash-decoding) and a small combine pass
merges the splits.  The source's header says what bounds it on the card.

The quantized (`qbits`), rotating sliding-window and `with_lse` (sequence-
parallel) variants are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dnet_tpu_torch.kernels import build

NEG_INF = -1e30
BK = 64  # keys per tile, in the kernel and in its plain version
HEAD_DIMS = (64, 128)
MAX_GROUP = 8  # query heads per KV head the kernel takes
# enough (split, KV head, batch) blocks for two per SM on a 132-SM card
TARGET_BLOCKS = 264


def split_plan(live: int, n_blocks_per_split: int) -> tuple[int, int]:
    """(tiles_per_split, n_split) covering the live tiles with about
    TARGET_BLOCKS blocks; every split holds at least one live tile."""
    n_tiles = -(-live // BK)
    want = max(1, min(n_tiles, -(-TARGET_BLOCKS // n_blocks_per_split)))
    tiles_per_split = -(-n_tiles // want)
    return tiles_per_split, -(-n_tiles // tiles_per_split)


def flash_decode_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: int,
    scale: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel wrapper: q [B, 1, H, D] attends cache slots [0, pos] of k/v
    [B, S, KVH, D]; [B, 1, H, D] out in q.dtype.  CUDA tensors launch the
    kernel (bf16 or f32, head dim 64 or 128, H/KVH <= 8) or raise; CPU
    tensors take the plain version."""
    pos = int(pos)
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"flash_decode_attend takes one query row, got T={T}")
    if k.dim() != 4 or k.shape[0] != B or k.shape[-1] != D or v.shape != k.shape:
        raise ValueError(f"cache shapes k {tuple(k.shape)} v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    S, KVH = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError(f"{H} query heads are not a multiple of {KVH} KV heads")
    if not 0 <= pos < S:
        raise ValueError(f"position {pos} outside a cache of {S} slots")
    if sinks is not None and tuple(sinks.shape) != (H,):
        raise ValueError(f"sinks must be [H]={H}, got {tuple(sinks.shape)}")
    scale = D**-0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, pos, scale=scale, sinks=sinks)
    if q.dtype not in build.DTYPE_CODES or D not in HEAD_DIMS or H // KVH > MAX_GROUP:
        raise ValueError(
            f"flash_decode takes bf16/f32, head dim 64/128 and at most {MAX_GROUP} "
            f"query heads per KV head; got {q.dtype}, {D}, {H // KVH}"
        )
    if sinks is not None:
        build.check_cuda_tensors("flash_decode", torch.float32, sinks=sinks)
    build.check_cuda_tensors("flash_decode", q.dtype, q=q, k=k, v=v)
    live = pos + 1
    tiles_per_split, n_split = split_plan(live, B * KVH)
    G = H // KVH
    part_o = torch.empty((B, KVH, n_split, G, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, KVH, n_split, G, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    rc = _entry()(
        build.DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if sinks is None else sinks.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), B, H, KVH, S, live,
        tiles_per_split, n_split, scale, build.current_stream_handle(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed (code {rc})")
    flash_decode_attend.launches += 1
    return out


flash_decode_attend.launches = 0  # kernel launches since the last reset

_P, _I = ctypes.c_void_p, ctypes.c_int
# dtype, head_dim, q, k, v, o, sinks, part_o, part_ml, B, H, KVH, S, live,
# tiles_per_split, n_split, scale, stream
_ARGTYPES = (
    _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P,
)


def _entry():
    return build.entry("flash_decode", "dnet_flash_decode", _ARGTYPES)


def flash_decode_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos: int,
    scale: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the online-softmax fold over
    the live 64-key tiles, in f32, sharing the tiles across each group."""
    B, _, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    Vd = v.shape[-1]
    scale = D**-0.5 if scale is None else float(scale)
    dev = q.device
    live = min(int(pos) + 1, S)
    qf = q[:, 0].reshape(B, KVH, G, D).float() * scale
    m = torch.full((B, KVH, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, Vd), dtype=torch.float32, device=dev)
    for k0 in range(0, live, BK):
        kt = k[:, k0 : min(k0 + BK, live)].float()
        vt = v[:, k0 : min(k0 + BK, live)].float()
        scores = torch.einsum("bkgd,bskd->bkgs", qf, kt)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgs,bskd->bkgd", p, vt)
        m = m_new
    if sinks is None:
        sink = torch.full((1, KVH, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    else:
        sink = sinks.float().reshape(1, KVH, G, 1)
    m_fin = torch.maximum(m, sink)
    corr = torch.exp(m - m_fin)
    l_fin = l * corr + torch.exp(sink - m_fin)
    out = acc * corr / torch.clamp(l_fin, min=1e-30)
    return out.reshape(B, 1, H, Vd).to(q.dtype)
