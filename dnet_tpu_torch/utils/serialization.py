"""Tensor <-> wire bytes and canonical dtype names.

Counterpart of dnet_tpu/utils/serialization.py: raw little-endian bytes
plus (dtype, shape) in the frame header, byte for byte the reference's
format.  bfloat16 has the same bit layout in torch and in `ml_dtypes`, so
it travels as its 16-bit pattern (torch int16 view, numpy uint16) and
needs no `ml_dtypes` here.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

# wire name -> torch dtype (the port's tensors); numpy_dtype maps bf16 to
# its uint16 bit container
_WIRE_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}

_ALIASES = {
    "f32": "float32", "f16": "float16", "bf16": "bfloat16", "f64": "float64",
    "i8": "int8", "u8": "uint8", "i16": "int16", "i32": "int32", "i64": "int64",
    "BF16": "bfloat16", "F16": "float16", "F32": "float32", "F64": "float64",
    "I8": "int8", "I16": "int16", "I32": "int32", "I64": "int64", "U8": "uint8",
    "BOOL": "bool",
}

_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def canonical_dtype_name(name: str) -> str:
    return _ALIASES.get(name, name)


def torch_dtype(name: str) -> torch.dtype:
    canon = canonical_dtype_name(name)
    if canon not in _WIRE_DTYPES:
        raise ValueError(f"unsupported wire dtype: {name!r}")
    return _WIRE_DTYPES[canon]


def numpy_dtype(name: str) -> np.dtype:
    """The numpy dtype holding a wire dtype's bytes (bf16: uint16 bits)."""
    dt = torch_dtype(name)
    if dt == torch.bfloat16:
        return np.dtype(np.uint16)
    return np.dtype(torch.empty((), dtype=dt).numpy().dtype)


def dtype_name(dtype: Union[torch.dtype, np.dtype, str]) -> str:
    """Canonical wire name of a torch (or numpy) dtype."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros((), dtype=np.dtype(dtype))).dtype
    if dtype not in _NAMES:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return _NAMES[dtype]


def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy().tobytes()


def tensor_to_bytes(x, wire_dtype: str | None = None) -> Tuple[bytes, str, Tuple[int, ...]]:
    """Serialize a torch tensor (any device) or numpy array to (payload,
    dtype name, shape), cast to `wire_dtype` first when given."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if wire_dtype is not None:
        t = t.to(torch_dtype(wire_dtype))
    return _host_bytes(t), dtype_name(t.dtype), tuple(t.shape)


def bytes_to_tensor(payload: Union[bytes, memoryview], dtype: str, shape: Sequence[int]) -> torch.Tensor:
    """Wire bytes -> a CPU tensor of the wire dtype (a copy: the payload
    buffer is read-only)."""
    nd = numpy_dtype(dtype)
    expected = int(np.prod(shape)) * nd.itemsize if shape else nd.itemsize
    if len(payload) != expected:
        raise ValueError(
            f"payload size mismatch: got {len(payload)} bytes, "
            f"expected {expected} for {dtype}{tuple(shape)}"
        )
    arr = np.frombuffer(payload, dtype=nd).copy().reshape(tuple(shape))
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if torch_dtype(dtype) == torch.bfloat16 else t


def to_device(t: torch.Tensor, device=None) -> torch.Tensor:
    """A CPU tensor onto `device`: to a card through page-locked memory, an
    asynchronous copy on the current stream (a copy from pageable memory
    would wait for the device); elsewhere the plain move."""
    if device is not None and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def bytes_to_device(payload: bytes, dtype: str, shape: Sequence[int], device=None) -> torch.Tensor:
    """Deserialize onto `device` (one host-to-device copy, `to_device`)."""
    return to_device(bytes_to_tensor(payload, dtype, shape), device)
