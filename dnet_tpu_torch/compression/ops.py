"""Column ops of the hop codec: three hand-written CUDA kernels and their
plain versions.

Counterpart of dnet_tpu/compression/ops.py.  The kernels
(csrc/column_ops.cu) replace two TPU kernels of that file:
  - `_norms_kernel` (:24): per-column sums of squares, `column_sq_norms`,
    and with the send side's `jax.lax.top_k` + sort (:198-205) fused in,
    `column_topk`: one launch that sums the columns and picks the kept ones;
  - `_matmul_kernel` (:81) against a one-hot matrix: the send side's column
    gather, `gather_columns`, and the receive side's column scatter with
    the q8 dequant fused in, `dequant_scatter_columns`.
The TPU side took its kernels only for exactly tiled shapes and fell back
to jnp otherwise (so a decode frame never reached them); these take every
R >= 1 and every C.  A wrapper launches its kernel for CUDA tensors or
raises, and takes the plain version only for CPU tensors; each counts its
launches.

The top-k keeps `jax.lax.top_k`'s order (NaN above +inf, ties to the
lowest index): a stable descending sort in the plain version, the first
`keep` indices, then sorted ascending (the wire bitmask convention).  The
q8 quantize runs outside any kernel in the reference too, so it is plain
torch ops here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dnet_tpu_torch.kernels import build

# enough blocks for two per SM on a 132-SM card
TARGET_BLOCKS = 264
# the dequant + scatter's blocks of a large frame: four per SM, each mapping
# its strip's kept columns once for a few rows
SCATTER_BLOCKS = 4 * 132
NTHREADS = 256  # threads per block in every kernel (csrc/column_ops.cu)
NORMS_WARPS = NTHREADS // 32
# a norms split walks at least this many rows: 4 a warp
MIN_ROWS_PER_SPLIT = 4 * NORMS_WARPS
MAX_GRID_Y = 65535
# shared memory a block may opt in to on an H100, less the selection's
# static arrays: column_topk holds all C norms in one block
MAX_SELECT_SMEM = 232448 - 2048
# dequant_scatter modes (csrc/column_ops.cu)
MODE_SCATTER, MODE_TENSOR, MODE_GROUP = 0, 1, 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_2d(op: str, x: torch.Tensor) -> Tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"{op} takes a 2D tensor, got shape {tuple(x.shape)}")
    return x.shape[0], x.shape[1]


# ---- B4: column sums of squares --------------------------------------------


def norms_strip(elem_bytes: int) -> int:
    """Columns a norms block owns: a warp's 512 bytes of a row."""
    return 32 * (16 // elem_bytes)


def norms_split(R: int, C: int, elem_bytes: int = 2) -> Tuple[int, int]:
    """(n_split, rows_per_split) for the norms kernel: rows split across
    blocks until about TARGET_BLOCKS run, each split at least
    MIN_ROWS_PER_SPLIT rows; a function of the shape alone, so the same
    input always sums in the same order (R = 1500 at C = 2048 in bf16:
    8 strips x 33 splits of 46 rows)."""
    strips = _cdiv(C, norms_strip(elem_bytes))
    want = max(1, min(_cdiv(TARGET_BLOCKS, strips), _cdiv(R, MIN_ROWS_PER_SPLIT), MAX_GRID_Y))
    rows_per_split = _cdiv(R, want)
    return _cdiv(R, rows_per_split), rows_per_split


def column_sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: x [R, C] bf16/f32 -> [C] f32, each column's sum of
    squares accumulated in f32.  CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version."""
    R, C = _check_2d("column_sq_norms", x)
    if R < 1 or C < 1:
        raise ValueError(f"column_sq_norms needs R, C >= 1, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return column_sq_norms_plain(x)
    return _norms_topk("column_sq_norms", x, 0)[0]


column_sq_norms.launches = 0  # kernel launches since the last reset (column_topk's too)


def column_sq_norms_plain(x: torch.Tensor) -> torch.Tensor:
    """The norms kernel's function in plain PyTorch."""
    xf = x.float()
    return (xf * xf).sum(dim=0)


def column_topk(x: torch.Tensor, keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: the `keep` columns of x [R, C] (bf16/f32) with the
    largest sums of squares -> (idx int32 [keep] ascending, bitmask uint8
    [ceil(C / 8)] packed as np.packbits), ties to the lower index.  One
    launch of the norms kernel with its selection on, counted on
    `column_sq_norms.launches`.  CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version."""
    R, C = _check_2d("column_topk", x)
    keep = int(keep)
    if R < 1 or C < 1 or not 1 <= keep <= C:
        raise ValueError(f"column_topk needs R, C >= 1 and 1 <= keep <= C, got {tuple(x.shape)}, keep={keep}")
    if x.device.type == "cpu":
        return column_topk_plain(x, keep)
    if 4 * C > MAX_SELECT_SMEM:
        raise ValueError(f"column_topk holds C norms in one block: C={C} exceeds {MAX_SELECT_SMEM // 4}")
    _, idx, mask = _norms_topk("column_topk", x, keep)
    return idx, mask


def column_topk_plain(x: torch.Tensor, keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """column_topk's function in plain PyTorch: the plain norms, the
    top-k (`topk_columns`) and the packed mask."""
    idx = topk_columns(column_sq_norms_plain(x), keep)
    return idx, pack_mask(idx, x.shape[1])


def pack_mask(idx: torch.Tensor, C: int) -> torch.Tensor:
    """Columns idx of C as a bitmask, np.packbits's order (bit 7 of byte b
    is column 8b), uint8 [ceil(C / 8)] on idx's device."""
    mask = torch.zeros(_cdiv(C, 8) * 8, dtype=torch.int32, device=idx.device)
    mask[idx.long()] = 1
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=idx.device)
    return (mask.view(-1, 8) * weights).sum(dim=1).to(torch.uint8)


# per (device, stream): the norms kernel's tickets, one a strip and one for
# the call (int32; the kernel returns them to 0, so a stream's calls share them)
_TICKETS: dict = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    key = (device, build.current_stream_handle(device))
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def _norms_topk(op: str, x: torch.Tensor, keep: int):
    """(norms [C] f32, idx, mask) from one launch; idx and mask are None
    when keep == 0."""
    R, C = x.shape
    if x.dtype not in build.DTYPE_CODES:
        raise ValueError(f"{op} takes bf16/f32, got {x.dtype}")
    build.check_cuda_tensors(op, x.dtype, x=x)
    n_split, rows_per_split = norms_split(R, C, x.element_size())
    dev = x.device
    norms = torch.empty(C, dtype=torch.float32, device=dev)
    partial = torch.empty((n_split, C), dtype=torch.float32, device=dev) if n_split > 1 else None
    tickets = None
    if n_split > 1 or keep:
        tickets = _tickets(dev, _cdiv(C, norms_strip(x.element_size())) + 1)
    idx = torch.empty(keep, dtype=torch.int32, device=dev) if keep else None
    mask = torch.empty(_cdiv(C, 8), dtype=torch.uint8, device=dev) if keep else None
    rc = _entry("dnet_column_norms_topk", _NORMS_ARGTYPES)(
        build.DTYPE_CODES[x.dtype], x.data_ptr(), _ptr(partial), norms.data_ptr(), _ptr(tickets),
        _ptr(idx), _ptr(mask), R, C, n_split, rows_per_split, keep, build.current_stream_handle(dev),
    )
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed (code {rc})")
    column_sq_norms.launches += 1
    return norms, idx, mask


# ---- B5, send side: column gather ------------------------------------------


def gather_columns(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: out[r, j] = x[r, idx[j]], [R, C] -> [R, K], equal bit
    for bit to x[:, idx].  idx is int32 [K] in [0, C); the codec's is sorted
    and unique, which lets the kernel stage each strip's span of x (any idx
    stays correct, read element by element).  CUDA tensors launch the kernel
    (2- or 4-byte elements) or raise; CPU tensors take the plain version."""
    R, C = _check_2d("gather_columns", x)
    if idx.dim() != 1:
        raise ValueError(f"gather_columns: idx must be 1D, got {tuple(idx.shape)}")
    K = idx.shape[0]
    if x.device.type == "cpu":
        return gather_columns_plain(x, idx)
    if x.element_size() not in (2, 4):
        raise ValueError(f"gather_columns takes 2- or 4-byte elements, got {x.dtype}")
    build.check_cuda_tensors("gather_columns", x.dtype, x=x)
    build.check_cuda_tensors("gather_columns", torch.int32, idx=idx)
    out = torch.empty((R, K), dtype=x.dtype, device=x.device)
    if R == 0 or K == 0:
        return out
    rc = _entry("dnet_gather_columns", _GATHER_ARGTYPES)(
        x.element_size(), x.data_ptr(), idx.data_ptr(), out.data_ptr(), R, C, K,
        build.current_stream_handle(x.device),
    )
    if rc != 0:
        raise RuntimeError(f"gather_columns kernel launch failed (code {rc})")
    gather_columns.launches += 1
    return out


gather_columns.launches = 0  # kernel launches since the last reset


def gather_columns_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather kernel's function in plain PyTorch."""
    return x[:, idx.long()]


# ---- B5, receive side: dequant + column scatter -----------------------------


def dequant_scatter_columns(
    src: torch.Tensor,
    idx: torch.Tensor,
    D: int,
    out_dtype: Optional[torch.dtype] = None,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    gs: int = 0,
) -> torch.Tensor:
    """Kernel wrapper: [R, K] kept columns -> [R, D] with column idx[j] set
    from src[:, j] and zeros at every other column.  idx is int32 [K],
    sorted ascending and unique, in [0, D).

    - src bf16/f32 (sparse_v1): a plain scatter, out in src's dtype;
    - src uint8 codes (qsparse8_v1): out = code * scale + bias in f32, then
      cast to `out_dtype`, with one scale/bias ([1] f32) when gs == 0, or
      [R, G] f32 over groups of gs kept columns.

    CUDA tensors launch the kernel or raise; CPU tensors take the plain
    version."""
    R, K = _check_2d("dequant_scatter_columns", src)
    D = int(D)
    if idx.dim() != 1 or idx.shape[0] != K or K > D:
        raise ValueError(f"dequant_scatter_columns: idx {tuple(idx.shape)} for {K} of {D} columns")
    mode, out_dtype = _scatter_mode(src, out_dtype, scale, bias, gs, R, K)
    if src.device.type == "cpu":
        return dequant_scatter_columns_plain(src, idx, D, out_dtype, scale, bias, gs)
    if out_dtype not in build.DTYPE_CODES:
        raise ValueError(f"dequant_scatter_columns writes bf16/f32, got {out_dtype}")
    build.check_cuda_tensors("dequant_scatter_columns", src.dtype, src=src)
    build.check_cuda_tensors("dequant_scatter_columns", torch.int32, idx=idx)
    out = torch.empty((R, D), dtype=out_dtype, device=src.device)
    if R == 0 or D == 0:
        return out
    G = 0
    if mode != MODE_SCATTER:
        build.check_cuda_tensors("dequant_scatter_columns", torch.float32, scale=scale, bias=bias)
        G = scale.shape[1] if mode == MODE_GROUP else 1
    _, _, rows_per_block = scatter_grid(R, D, out_dtype)
    rc = _entry("dnet_dequant_scatter_columns", _SCATTER_ARGTYPES)(
        build.DTYPE_CODES[out_dtype], mode, src.data_ptr(),
        None if scale is None else scale.data_ptr(), None if bias is None else bias.data_ptr(),
        idx.data_ptr(), out.data_ptr(), R, D, K, int(gs), G, rows_per_block,
        build.current_stream_handle(src.device),
    )
    if rc != 0:
        raise RuntimeError(f"dequant_scatter_columns kernel launch failed (code {rc})")
    dequant_scatter_columns.launches += 1
    return out


dequant_scatter_columns.launches = 0  # kernel launches since the last reset


def scatter_grid(R: int, D: int, out_dtype: torch.dtype) -> Tuple[int, int, int]:
    """(strip columns, strips, rows per block) of the dequant + scatter
    kernel: a thread writes 16 bytes of a row, so a block's strip is
    NTHREADS x (8 bf16 or 4 f32) columns, and a frame's rows are cut so that
    about SCATTER_BLOCKS blocks run (R = 1500 at the hop's D = 2048: 500)."""
    strip = NTHREADS * (16 // torch.tensor([], dtype=out_dtype).element_size())
    strips = _cdiv(D, strip)
    row_groups = min(R, max(1, _cdiv(SCATTER_BLOCKS, strips)))
    return strip, strips, max(_cdiv(R, row_groups), _cdiv(R, MAX_GRID_Y))


def _scatter_mode(src, out_dtype, scale, bias, gs, R, K) -> Tuple[int, torch.dtype]:
    """(kernel mode, output dtype) after checking the quant params' shapes."""
    if src.dtype != torch.uint8:
        if scale is not None or bias is not None:
            raise ValueError("a plain scatter takes no scale/bias")
        if out_dtype not in (None, src.dtype):
            raise ValueError(f"a plain scatter keeps src's dtype {src.dtype}, not {out_dtype}")
        return MODE_SCATTER, src.dtype
    if scale is None or bias is None or out_dtype is None:
        raise ValueError("uint8 codes need scale, bias and out_dtype")
    if gs == 0:
        want = (1,)
    elif gs > 0:
        want = (R, _cdiv(K, gs))
    else:
        raise ValueError(f"group size must be >= 0, got {gs}")
    if tuple(scale.shape) != want or tuple(bias.shape) != want:
        raise ValueError(
            f"scale {tuple(scale.shape)} / bias {tuple(bias.shape)} do not match {want} for gs={gs}"
        )
    return (MODE_TENSOR if gs == 0 else MODE_GROUP), out_dtype


def dequant_scatter_columns_plain(
    src: torch.Tensor,
    idx: torch.Tensor,
    D: int,
    out_dtype: Optional[torch.dtype] = None,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    gs: int = 0,
) -> torch.Tensor:
    """The dequant + scatter kernel's function in plain PyTorch: the
    dequant is one f32 multiply and one f32 add, each rounded, as the
    kernel's __fmul_rn/__fadd_rn."""
    R, K = src.shape
    if src.dtype == torch.uint8:
        cf = src.float()
        if gs == 0:
            kept = cf * scale[0] + bias[0]
        else:
            group = torch.arange(K, device=src.device) // gs
            kept = cf * scale[:, group] + bias[:, group]
        kept = kept.to(out_dtype)
    else:
        kept = src
    out = torch.zeros((R, int(D)), dtype=kept.dtype, device=src.device)
    out[:, idx.long()] = kept
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int
# dtype, x, partial, norms, tickets, idx, mask, R, C, n_split, rows_per_split, keep, stream
_NORMS_ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
# elem_bytes, x, idx, out, R, C, K, stream
_GATHER_ARGTYPES = (_I, _P, _P, _P, _I, _I, _I, _P)
# dtype, mode, src, scale, bias, idx, out, R, D, K, gs, G, rows_per_block, stream
_SCATTER_ARGTYPES = (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _entry(symbol: str, argtypes):
    return build.entry("column_ops", symbol, argtypes)


# ---- the reference's public ops --------------------------------------------


def column_l2_norms(x: torch.Tensor) -> torch.Tensor:
    """Squared L2 norm per column of [R, C] -> [C] f32 (the norms kernel)."""
    return column_sq_norms(x)


def scatter_columns(kept: torch.Tensor, idx: torch.Tensor, D: int) -> torch.Tensor:
    """[R, K] -> [R, D]: kept columns back in place, zeros elsewhere."""
    return dequant_scatter_columns(kept, idx, D)


def topk_columns(norms: torch.Tensor, keep: int) -> torch.Tensor:
    """Indices of the `keep` largest norms, ascending, int32 on norms'
    device; ties go to the lower index, as `jax.lax.top_k` breaks them."""
    order = torch.sort(norms, descending=True, stable=True).indices[:keep]
    return torch.sort(order).values.to(torch.int32)


def keep_count(D: int, drop_frac: float) -> int:
    """Columns kept of D at a drop fraction (the reference's rounding)."""
    return max(int(round(D * (1.0 - drop_frac))), 1)


def quantize_q8(kept: torch.Tensor, gs: int):
    """Affine uint8 over the kept columns, the reference's math
    (compression/ops.py:208): kept [R, K] -> (codes uint8 [R, K], scale
    f32, bias f32).  gs > 0: per-(row, group of gs kept columns) params,
    the zero padding of the last group included; gs == 0: one per-tensor
    scale/bias pair."""
    R, K = kept.shape
    kf = kept.float()
    if gs == 0:
        mn = kf.min()
        scale = torch.clamp((kf.max() - mn) / 255.0, min=1e-12)
        codes = torch.clamp(torch.round((kf - mn) / scale), 0, 255).to(torch.uint8)
        return codes, scale.reshape(1), mn.reshape(1)
    G = _cdiv(K, gs)
    kf = F.pad(kf, (0, G * gs - K)).reshape(R, G, gs)
    mn = kf.amin(dim=-1)
    mx = kf.amax(dim=-1)
    scale = torch.clamp((mx - mn) / 255.0, min=1e-12)
    codes = torch.clamp(torch.round((kf - mn[..., None]) / scale[..., None]), 0, 255)
    return codes.to(torch.uint8).reshape(R, G * gs)[:, :K].contiguous(), scale, mn


def column_sparsify(x: torch.Tensor, drop_frac: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero the `drop_frac` fraction of columns with the smallest L2 norm:
    (sparsified x, keep mask [C] bool)."""
    C = x.shape[1]
    idx = topk_columns(column_l2_norms(x), keep_count(C, drop_frac))
    mask = torch.zeros(C, dtype=torch.bool, device=x.device)
    mask[idx.long()] = True
    return torch.where(mask[None, :], x, torch.zeros_like(x)), mask
