"""HF-format checkpoint access through the port's native host store.

Counterpart of dnet_tpu/utils/checkpoint.py (`Checkpoint`,
`save_checkpoint`) without the `safetensors` package: each file is mapped
once by utils/native_store.py `NativeSafetensors`, which parses the header
(an 8-byte little-endian length, a JSON index mapping each tensor name to
{dtype, shape, data_offsets}, then the raw little-endian bytes).
`load_tensor` returns an owning CPU tensor (bf16 included, which numpy
cannot hold); `tensor_view` the zero-copy view the weight-streaming host
store reads (core/weights.py).  `prefetch_layer` / `release_layer` stream
one layer's spans into and out of the page cache; a fit load's layer and
edge reads advise WILLNEED first, so a cold file is read ahead as the
buffered reads of a plain file reader were.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from dnet_tpu_torch.utils.native_store import DTYPES, NativeSafetensors

_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")

_NAMES = {v: k for k, v in DTYPES.items()}


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
        # tensor name -> its file's mapping
        self._where: Dict[str, NativeSafetensors] = {}
        for path in files:
            st = NativeSafetensors(path)
            for name in st.keys():
                self._where[name] = st

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

    def tensor_view(self, name: str) -> torch.Tensor:
        """Zero-copy CPU view of one tensor in its mapped file."""
        return self._where[name].tensor(name)

    def load_tensor(self, name: str) -> torch.Tensor:
        return self.tensor_view(name).clone()

    def load_layer_raw(self, layer: int, view: bool = False) -> Dict[str, torch.Tensor]:
        """One layer's tensors keyed by suffix (prefix stripped): owning
        copies, read after a WILLNEED on the layer's spans so the kernel
        reads them ahead of the copy; `view`: zero-copy views."""
        if layer not in self.layer_tensors:
            raise KeyError(f"layer {layer} not in checkpoint")
        if view:
            return {s: self.tensor_view(full) for s, full in self.layer_tensors[layer].items()}
        self.prefetch_layer(layer, sync=True)
        return {s: self.load_tensor(full) for s, full in self.layer_tensors[layer].items()}

    def load_edge_raw(self, names: Optional[List[str]] = None) -> Dict[str, torch.Tensor]:
        """Non-layer tensors (embed/final-norm/lm-head), all or a subset
        (owning copies, read after a WILLNEED like a layer's)."""
        keys = [k for k in (names if names is not None else self.edge_tensors) if k in self.edge_tensors]
        for st, group in self._by_file(keys).items():
            st.prefetch(group, sync=True)
        return {k: self.load_tensor(k) for k in keys}

    def close(self) -> None:
        """Unmap every file (a fit engine once its tensors are copied out:
        a mapping would keep the files' pages, and a deleted file, alive);
        reads after it raise."""
        for st in set(self._where.values()):
            st.close()

    # ---- page-cache streaming -------------------------------------------
    def _by_file(self, names: List[str]) -> Dict[NativeSafetensors, List[str]]:
        by_file: Dict[NativeSafetensors, List[str]] = {}
        for full in names:
            by_file.setdefault(self._where[full], []).append(full)
        return by_file

    def prefetch_layer(self, layer: int, sync: bool = False) -> None:
        """WILLNEED on one layer's spans and, unless `sync`, a background
        page-touch, so its disk reads overlap compute."""
        for st, names in self._by_file(list(self.layer_tensors.get(layer, {}).values())).items():
            st.prefetch(names, sync=sync)

    def release_layer(self, layer: int) -> None:
        """DONTNEED an evicted layer's spans."""
        for st, names in self._by_file(list(self.layer_tensors.get(layer, {}).values())).items():
            st.release(names)


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
