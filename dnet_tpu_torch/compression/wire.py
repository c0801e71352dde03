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

The send side runs on the device in two halves (`launch_encode`, then
`DeviceEncode.finalize`; `compress_tensor` is the two back to back): the
launch runs column norms and top-k (one kernel, which also writes the
bitmask), the column gather (kernel) and the quantize, or the plain cast of
the lossless codec, then queues copies of the outputs into page-locked
host buffers and records an event, with no host sync; the finalize waits
on the event and packs the bytes on the host.  Only the kept columns and
the bitmask leave the card.  Under the wire pipeline the compute thread
launches and the transport's tx thread finalizes (transport/
wire_pipeline.py), reusing the buffers `EncodeStaging` keeps for each
encode-ring slot.
The receive side uploads the compact buffers through page-locked memory
(an asynchronous copy) and runs the fused dequant + scatter kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dnet_tpu_torch.compression.ops import (
    column_topk,
    dequant_scatter_columns,
    gather_columns,
    keep_count,
    quantize_q8,
)
from dnet_tpu_torch.utils.serialization import dtype_name, numpy_dtype, to_device, torch_dtype

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


class EncodeStaging:
    """Page-locked host buffers of pipelined encodes: `depth` sets for each
    layout of buffers (a codec at a row count), set `slot` belonging to the
    encode ring's slot of that number (transport/wire_pipeline.py
    `EncodeRing`).  A slot is free again only once its encode was packed or
    discarded, so a launch never copies into buffers that a finalize may
    still be reading, whatever order the encodes are released in."""

    def __init__(self, depth: int) -> None:
        self.depth = max(int(depth), 1)
        self._sets: Dict[tuple, List[List[torch.Tensor]]] = {}

    def take(self, specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]], slot: int) -> List[torch.Tensor]:
        key = tuple(specs)
        sets = self._sets.get(key)
        if sets is None:
            sets = self._sets[key] = [[torch.empty(shape, dtype=dt, pin_memory=True) for shape, dt in key]
                                      for _ in range(self.depth)]
        return sets[slot]


def _host_bytes(t: torch.Tensor) -> bytes:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


class DeviceEncode:
    """A launched hop encode whose bytes are not on the host yet: `dtype`
    and `shape` are final, `host` the page-locked buffers the device's
    outputs are being copied into (CPU tensors: the plain versions' own
    outputs), `event` the copies' completion (None on the CPU).
    `finalize` (any thread) waits on the event and packs the payload: it
    launches nothing."""

    __slots__ = ("host", "event", "dtype", "shape")

    def __init__(self, host: List[torch.Tensor], event, dtype: str, shape: Tuple[int, ...]) -> None:
        self.host = host
        self.event = event
        self.dtype = dtype
        self.shape = tuple(shape)

    def finalize(self) -> bytes:
        if self.event is not None:
            self.event.synchronize()
        return b"".join(_host_bytes(t) for t in self.host)


def launch_encode(
    x: torch.Tensor,
    drop_frac: float,
    wire_dtype: str = "bfloat16",
    quant_bits: int = 0,
    group_size: int = 64,
    staging: Optional[EncodeStaging] = None,
    slot: int = 0,
    cast: bool = True,
) -> DeviceEncode:
    """Queue the hop encode of x ([B, T, D] or [R, D]) on its device:
    quant_bits 8 selects qsparse8_v1 (drop_frac may be 0: int8 over every
    column), drop_frac > 0 with quant_bits 0 sparse_v1, else the lossless
    cast to `wire_dtype`.  On a CUDA tensor the outputs are copied
    (non_blocking) into page-locked buffers, `staging`'s set `slot` (the
    encode-ring slot the caller holds) or new ones, and an event is
    recorded; nothing waits for the device.  `cast` False
    keeps sparse_v1 at drop_frac 0 (every column kept), as
    compress_tensor does."""
    if quant_bits not in (0, 8):
        raise NotImplementedError(f"compress quant_bits={quant_bits} (0 or 8)")
    orig_shape = tuple(x.shape)
    D = orig_shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    wt = torch_dtype(wire_dtype)
    if cast and drop_frac <= 0 and quant_bits == 0:
        bufs, dtype = [x2.to(wt)], dtype_name(wt)
    else:
        idx, mask = column_topk(x2, keep_count(D, drop_frac))
        kept = gather_columns(x2, idx)
        if quant_bits == 0:
            bufs = [mask, kept.to(wt)]
            dtype = f"{wire_dtype}|{FMT_TAG}|pct={drop_frac:g}|orig={D}"
        else:
            gs = _effective_group(kept.shape[1], group_size)
            codes, scale, bias = quantize_q8(kept, gs)
            bufs = [mask, codes, scale.to(torch.float32), bias.to(torch.float32)]
            dtype = f"{wire_dtype}|{QFMT_TAG}|pct={drop_frac:g}|orig={D}|gs={gs}"
    if not x2.is_cuda:
        return DeviceEncode([b.contiguous() for b in bufs], None, dtype, orig_shape)
    specs = [(tuple(b.shape), b.dtype) for b in bufs]
    host = (staging.take(specs, slot) if staging is not None
            else [torch.empty(shape, dtype=dt, pin_memory=True) for shape, dt in specs])
    for h, b in zip(host, bufs):
        h.copy_(b, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(x2.device))
    return DeviceEncode(host, event, dtype, orig_shape)


def compress_tensor(
    x: torch.Tensor,
    drop_frac: float,
    wire_dtype: str = "bfloat16",
    quant_bits: int = 0,
    group_size: int = 64,
) -> Tuple[bytes, str, Tuple[int, ...]]:
    """[B, T, D] (or [R, D]) activations -> (payload, tagged dtype, shape):
    the launch and its finalize back to back.  quant_bits=8 selects
    qsparse8_v1, 0 sparse_v1."""
    enc = launch_encode(x, drop_frac, wire_dtype=wire_dtype, quant_bits=quant_bits, group_size=group_size,
                        cast=False)
    return enc.finalize(), enc.dtype, enc.shape


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
    return to_device(torch.from_numpy(arr), device)


def decompress_tensor_device(payload: bytes, dtype: str, shape: Tuple[int, ...], device=None) -> torch.Tensor:
    """Inverse of compress_tensor on `device`: the header is parsed on the
    host, only the compact buffers upload, and the dequant + scatter kernel
    rebuilds [R, D] with zeros at dropped columns.  Returns the base dtype
    in the original shape."""
    base, fields, D, mask_bytes, bitmask, K, R = _parse_header(payload, dtype, shape)
    out_dtype = torch_dtype(base)
    idx = to_device(torch.from_numpy(np.nonzero(bitmask)[0].astype(np.int32)), device)
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
