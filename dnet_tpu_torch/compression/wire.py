"""Sparse wire formats of the ring's hidden-state hops.

Counterpart of dnet_tpu/compression/wire.py:48-258, the same two formats
byte for byte, with their metadata in the frame's dtype string:

  sparse_v1   kept columns verbatim
    dtype   = "<base>|fmt=sparse_v1|pct=<drop_frac>|orig=<C>"
    payload = [column bitmask ceil(C/8)] + [kept columns, <base>]

  qsparse8_v1 kept columns as affine uint8
    dtype   = "<base>|fmt=qsparse8_v1|pct=<drop_frac>|orig=<C>|gs=<G>"
    payload = [column bitmask] + [uint8 codes R*K] +
              [f32 scales R*ceil(K/gs)] + [f32 biases R*ceil(K/gs)]
    gs=0 marks the per-tensor fallback (fewer kept columns than one
    group): exactly one f32 scale and one f32 bias.

The send side runs on the device: column norms and top-k (one kernel, which
also writes the bitmask), the column gather (kernel) and the quantize; only
the kept columns and the bitmask leave the card.
The receive side uploads the compact buffers and runs the fused dequant +
scatter kernel.  The byte packing is on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dnet_tpu_torch.compression.ops import (
    column_topk,
    dequant_scatter_columns,
    gather_columns,
    keep_count,
    quantize_q8,
)
from dnet_tpu_torch.utils.serialization import numpy_dtype, tensor_to_bytes, torch_dtype

FMT_TAG = "fmt=sparse_v1"
QFMT_TAG = "fmt=qsparse8_v1"


def is_compressed_dtype(dtype: str) -> bool:
    return "|" in dtype and (FMT_TAG in dtype or QFMT_TAG in dtype)


def codec_name(dtype: str) -> str:
    """Name of the hop codec a frame's dtype tag selects."""
    if QFMT_TAG in dtype:
        return "qsparse8_v1"
    if FMT_TAG in dtype:
        return "sparse_v1"
    return dtype  # a plain wire dtype: the lossless codec


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().cpu().numpy().tobytes()


def _f32_bytes(t: torch.Tensor) -> bytes:
    return _bytes(t.to(torch.float32))


def compress_tensor(
    x: torch.Tensor,
    drop_frac: float,
    wire_dtype: str = "bfloat16",
    quant_bits: int = 0,
    group_size: int = 64,
) -> Tuple[bytes, str, Tuple[int, ...]]:
    """[B, T, D] (or [R, D]) activations -> (payload, tagged dtype, shape).
    quant_bits=8 selects qsparse8_v1, 0 sparse_v1."""
    if quant_bits not in (0, 8):
        raise NotImplementedError(f"compress quant_bits={quant_bits} (0 or 8)")
    orig_shape = tuple(x.shape)
    D = orig_shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    idx, mask = column_topk(x2, keep_count(D, drop_frac))
    kept = gather_columns(x2, idx)
    # the kept data first: its copy waits for the device, the mask's then does not
    if quant_bits == 0:
        data, _, _ = tensor_to_bytes(kept, wire_dtype=wire_dtype)
        return _bytes(mask) + data, f"{wire_dtype}|{FMT_TAG}|pct={drop_frac:g}|orig={D}", orig_shape
    gs = _effective_group(kept.shape[1], group_size)
    codes, scale, bias = quantize_q8(kept, gs)
    data = _bytes(codes) + _f32_bytes(scale) + _f32_bytes(bias)
    return _bytes(mask) + data, f"{wire_dtype}|{QFMT_TAG}|pct={drop_frac:g}|orig={D}|gs={gs}", orig_shape


def _effective_group(K: int, group_size: int) -> int:
    """The group size a K-kept-column frame quantizes with: 0 (per-tensor)
    when the frame cannot fill one group."""
    gs = max(int(group_size), 0)
    return 0 if K < gs or gs == 0 else gs


def _parse_header(payload: bytes, dtype: str, shape: Tuple[int, ...]):
    """(base dtype, fields, D, mask_bytes, bitmask [D] bool, K, R)."""
    if not is_compressed_dtype(dtype):
        raise ValueError(f"not a compressed dtype tag: {dtype!r}")
    base = dtype.split("|", 1)[0]
    fields = dict(part.split("=", 1) for part in dtype.split("|")[1:] if "=" in part)
    D = int(fields["orig"])
    mask_bytes = (D + 7) // 8
    bitmask = np.unpackbits(np.frombuffer(payload[:mask_bytes], dtype=np.uint8), count=D).astype(bool)
    K = int(bitmask.sum())
    R = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    return base, fields, D, mask_bytes, bitmask, K, R


def _buffer(payload: bytes, start: int, end: int, np_dtype, shape, device) -> torch.Tensor:
    arr = np.frombuffer(payload[start:end], dtype=np_dtype).copy().reshape(shape)
    return torch.from_numpy(arr).to(device)


def decompress_tensor_device(payload: bytes, dtype: str, shape: Tuple[int, ...], device=None) -> torch.Tensor:
    """Inverse of compress_tensor on `device`: the header is parsed on the
    host, only the compact buffers upload, and the dequant + scatter kernel
    rebuilds [R, D] with zeros at dropped columns.  Returns the base dtype
    in the original shape."""
    base, fields, D, mask_bytes, bitmask, K, R = _parse_header(payload, dtype, shape)
    out_dtype = torch_dtype(base)
    idx = torch.from_numpy(np.nonzero(bitmask)[0].astype(np.int32)).to(device)
    if QFMT_TAG in dtype:
        gs = int(fields["gs"])
        codes_end = mask_bytes + R * K
        codes = _buffer(payload, mask_bytes, codes_end, np.uint8, (R, K), device)
        pshape = (1,) if gs == 0 else (R, -(-K // gs))
        n = int(np.prod(pshape)) * 4
        scale = _buffer(payload, codes_end, codes_end + n, np.float32, pshape, device)
        bias = _buffer(payload, codes_end + n, codes_end + 2 * n, np.float32, pshape, device)
        out = dequant_scatter_columns(codes, idx, D, out_dtype, scale, bias, gs)
    else:
        nd = numpy_dtype(base)
        kept = _buffer(payload, mask_bytes, mask_bytes + R * K * nd.itemsize, nd, (R, K), device)
        if out_dtype == torch.bfloat16:
            kept = kept.view(torch.bfloat16)
        out = dequant_scatter_columns(kept, idx, D)
    return out.reshape(shape)


def decompress_tensor(payload: bytes, dtype: str, shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of compress_tensor on the host: a CPU tensor of the base
    dtype (the plain versions of the kernels)."""
    return decompress_tensor_device(payload, dtype, shape, device="cpu")
