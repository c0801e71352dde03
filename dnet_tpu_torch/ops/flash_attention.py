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
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dnet_tpu_torch.kernels import build

NEG_INF = -1e30
BK = 64  # keys per tile, in the kernel and in its plain version
# (q/k head dim, v head dim) pairs the kernel is built for
HEAD_DIMS = frozenset({(64, 64), (128, 128), (192, 128)})


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
