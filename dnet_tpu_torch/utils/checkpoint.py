"""HF-format checkpoint access with the port's own safetensors reader/writer.

Counterpart of dnet_tpu/utils/checkpoint.py (`Checkpoint`,
`save_checkpoint`) without the `safetensors` package: the format is an
8-byte little-endian header length, a JSON header mapping each tensor name
to {dtype, shape, data_offsets}, and the raw little-endian bytes.  Tensors
load as CPU torch tensors (bf16 included, which numpy cannot hold).
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_header(path: Path) -> Tuple[dict, int]:
    """(header without __metadata__, byte offset of the data section)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_tensor(path: Path, meta: dict, data_start: int) -> torch.Tensor:
    begin, end = meta["data_offsets"]
    dtype = _DTYPES.get(meta["dtype"])
    if dtype is None:
        raise ValueError(f"unsupported safetensors dtype {meta['dtype']} in {path}")
    buf = bytearray(end - begin)
    with open(path, "rb") as f:
        f.seek(data_start + begin)
        f.readinto(buf)
    if not buf:
        return torch.empty(meta["shape"], dtype=dtype)
    return torch.frombuffer(buf, dtype=dtype).reshape(meta["shape"])


def save_safetensors(path: Path, tensors: Mapping[str, torch.Tensor]) -> None:
    """Write tensors (CPU or device) as one safetensors file."""
    header = {}
    offset = 0
    payload = []
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        nbytes = t.numel() * t.element_size()
        header[name] = {
            "dtype": _NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        payload.append(t)
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # data section 8-byte aligned, as the reference writer pads
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in payload:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())


class Checkpoint:
    """An HF-format model directory: config.json + *.safetensors [+ index]."""

    def __init__(self, model_dir: Union[str, Path]):
        self.dir = Path(model_dir)
        cfg_path = self.dir / "config.json"
        if not cfg_path.is_file():
            raise FileNotFoundError(f"no config.json in {self.dir}")
        self.config: dict = json.loads(cfg_path.read_text())

        index = self.dir / "model.safetensors.index.json"
        if index.is_file():
            files = sorted({self.dir / f for f in json.loads(index.read_text())["weight_map"].values()})
        else:
            files = sorted(self.dir.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors in {self.dir}")
        # tensor name -> (file, header entry, data offset)
        self._where: Dict[str, Tuple[Path, dict, int]] = {}
        for path in files:
            header, start = read_header(path)
            for name, meta in header.items():
                self._where[name] = (path, meta, start)

        self.layer_tensors: Dict[int, Dict[str, str]] = {}  # layer -> suffix -> full name
        self.edge_tensors: Dict[str, str] = {}
        for name in self._where:
            m = _LAYER_RE.match(name)
            if m:
                self.layer_tensors.setdefault(int(m.group(1)), {})[m.group(2)] = name
            else:
                self.edge_tensors[name] = name

    @property
    def num_layers(self) -> int:
        return int(self.config["num_hidden_layers"])

    def load_tensor(self, name: str) -> torch.Tensor:
        path, meta, start = self._where[name]
        return read_tensor(path, meta, start)

    def load_layer_raw(self, layer: int) -> Dict[str, torch.Tensor]:
        """One layer's tensors keyed by suffix (prefix stripped)."""
        if layer not in self.layer_tensors:
            raise KeyError(f"layer {layer} not in checkpoint")
        return {s: self.load_tensor(full) for s, full in self.layer_tensors[layer].items()}

    def load_edge_raw(self, names: Optional[List[str]] = None) -> Dict[str, torch.Tensor]:
        """Non-layer tensors (embed/final-norm/lm-head), all or a subset."""
        keys = names if names is not None else list(self.edge_tensors)
        return {k: self.load_tensor(k) for k in keys if k in self.edge_tensors}


def save_checkpoint(
    model_dir: Union[str, Path],
    config: dict,
    tensors: Mapping[str, Union[torch.Tensor, np.ndarray]],
) -> None:
    """Write an HF-style single-file checkpoint."""
    d = Path(model_dir)
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(config, indent=2))
    save_safetensors(
        d / "model.safetensors",
        {k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
         for k, v in tensors.items()},
    )
