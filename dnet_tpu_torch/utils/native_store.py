"""The native host store (csrc/hoststore.cpp) through ctypes: safetensors
files mapped once, tensors as zero-copy views, and page-cache streaming.

Counterpart of dnet_tpu/utils/native_store.py.  The library builds with
g++ at first use into `build/dnet_tpu_torch/` (beside the CUDA kernels,
keyed by a hash of its source); a build failure raises, there is no
pure-Python path.  `NativeSafetensors` maps one file and parses its header
from the mapping (8-byte little-endian length, then the JSON index whose
offsets are relative to the data section after it); `tensor(name)` is a
CPU tensor over the mapped bytes (bf16 included: torch reads its bits as
they are), valid while the file stays open.

Page-cache streaming:
  prefetch(names)             WILLNEED plus a background page-touch, so the
                              next window's disk reads overlap compute
  prefetch(names, sync=True)  WILLNEED only: the kernel reads the spans
                              ahead of a copy that follows at once (a
                              fit load's layers and edge)
  release(names)              DONTNEED the spans of an evicted layer
Spans closer than a page are merged first (`_coalesced`), so one layer's
tensors take one madvise per run of the file.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple, Union

import torch

SRC = Path(__file__).resolve().parents[1] / "csrc" / "hoststore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dnet_tpu_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"hoststore-{h.hexdigest()[:16]}.so"


def ensure_built() -> Path:
    """Compile the library unless this source is built already; raises
    with g++'s output when the build fails."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name first: two processes may build at once
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native host store build failed ({' '.join(cmd)}):\n{proc.stderr.strip()}")
    os.replace(tmp, out)
    return out


def lib():
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(ensure_built()))
            handle.hs_open.argtypes = [ctypes.c_char_p]
            handle.hs_open.restype = ctypes.c_int
            handle.hs_close.argtypes = [ctypes.c_int]
            handle.hs_close.restype = None
            handle.hs_size.argtypes = [ctypes.c_int]
            handle.hs_size.restype = ctypes.c_uint64
            handle.hs_addr.argtypes = [ctypes.c_int]
            handle.hs_addr.restype = ctypes.c_void_p
            for f in (handle.hs_prefetch, handle.hs_prefetch_async, handle.hs_release):
                f.argtypes = [ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64]
                f.restype = ctypes.c_int
            _lib = handle
        return _lib


class NativeSafetensors:
    """One safetensors file: the native mapping, its parsed header and
    zero-copy tensor views."""

    def __init__(self, path: Union[str, Path]):
        self._lib = lib()
        self.path = Path(path)
        self._h = self._lib.hs_open(str(self.path).encode())
        if self._h < 0:
            raise OSError(f"hs_open failed for {self.path}")
        self.size = int(self._lib.hs_size(self._h))
        self._buf = (ctypes.c_char * self.size).from_address(self._lib.hs_addr(self._h))
        # every view holds the buffer, and the buffer this object: the file
        # stays mapped while a view lives (unless closed explicitly)
        self._buf.owner = self
        if self.size < 8:
            raise ValueError(f"corrupt safetensors header in {self.path}")
        (hdr_len,) = struct.unpack("<Q", self._buf[:8])
        if 8 + hdr_len > self.size:
            raise ValueError(f"corrupt safetensors header in {self.path}")
        header = json.loads(self._buf[8 : 8 + hdr_len].decode("utf-8"))
        header.pop("__metadata__", None)
        data0 = 8 + hdr_len
        # name -> (absolute offset, bytes, dtype, shape)
        self.tensors: Dict[str, Tuple[int, int, torch.dtype, Tuple[int, ...]]] = {}
        for name, info in header.items():
            dtype = DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"unsupported safetensors dtype {info['dtype']} in {self.path}")
            a, b = info["data_offsets"]
            self.tensors[name] = (data0 + a, b - a, dtype, tuple(info["shape"]))

    def keys(self) -> List[str]:
        return list(self.tensors)

    def tensor(self, name: str) -> torch.Tensor:
        """A CPU tensor over the mapped bytes (no copy; never write it:
        the mapping is read only)."""
        off, nbytes, dtype, shape = self.tensors[name]
        if nbytes == 0:
            return torch.empty(shape, dtype=dtype)
        item = torch.empty((), dtype=dtype).element_size()
        return torch.frombuffer(self._buf, dtype=dtype, count=nbytes // item, offset=off).reshape(shape)

    def span(self, name: str) -> Tuple[int, int]:
        off, nbytes, _, _ = self.tensors[name]
        return off, nbytes

    def _coalesced(self, names: Iterable[str]) -> List[Tuple[int, int]]:
        """Tensor spans merged into maximal runs (gaps under a page join)."""
        out: List[Tuple[int, int]] = []
        for off, nbytes in sorted(self.span(n) for n in names):
            if out and off <= out[-1][0] + out[-1][1] + 4096:
                prev_off, prev_len = out[-1]
                out[-1] = (prev_off, max(prev_len, off + nbytes - prev_off))
            else:
                out.append((off, nbytes))
        return out

    def prefetch(self, names: Iterable[str], sync: bool = False) -> None:
        fn = self._lib.hs_prefetch if sync else self._lib.hs_prefetch_async
        for off, nbytes in self._coalesced(names):
            fn(self._h, off, nbytes)

    def release(self, names: Iterable[str]) -> None:
        for off, nbytes in self._coalesced(names):
            self._lib.hs_release(self._h, off, nbytes)

    def close(self) -> None:
        """Unmap the file; views made from it must not be read after."""
        if self._h >= 0:
            self._buf.owner = None
            self._buf = None
            self._lib.hs_close(self._h)
            self._h = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
