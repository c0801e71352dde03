"""KV cache: preallocated and layer-stacked.

Counterpart of dnet_tpu/core/kvcache.py (unquantized, full-length caches).
Layout: k/v are [L, B, S_max, KVH, Hd]; a layer's slices `cache[name][l]`
are contiguous [B, S_max, KVH, Hd] views, which the attention kernels read
in place.

Unlike JAX's `dynamic_update_slice`, which clamps an out-of-range start and
would silently shift the write, `write_kv` raises when a chunk does not
fit; the engine keeps every chunk inside the cache by padding to at most
`max_seq - pos` tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class KVConfig:
    n_layers: int  # local layers in this cache
    batch: int
    max_seq: int
    n_kv_heads: int
    head_dim: int  # key head dim
    dtype: str = "bfloat16"


def init_cache(cfg: KVConfig, device: torch.device) -> dict:
    shape = (cfg.n_layers, cfg.batch, cfg.max_seq, cfg.n_kv_heads, cfg.head_dim)
    dt = getattr(torch, cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def layer_slices(cache: dict, layer: int) -> dict:
    """One layer's cache views (writes through them land in `cache`)."""
    return {name: arr[layer] for name, arr in cache.items()}


def write_kv(kvs: dict, k_new: torch.Tensor, v_new: torch.Tensor, pos: int) -> dict:
    """Write new k/v ([B, T, KVH, Hd]) at slot `pos` of one layer's cache
    slices, IN PLACE (the reference returns an updated copy); returns kvs."""
    T = k_new.shape[1]
    S = kvs["k"].shape[1]
    if pos < 0 or pos + T > S:
        raise ValueError(f"KV write [{pos}, {pos + T}) outside a cache of {S} slots")
    for name, val in (("k", k_new), ("v", v_new)):
        kvs[name][:, pos : pos + T] = val.to(kvs[name].dtype)
    return kvs


def read_kv(kvs: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-cache k/v for attention (the cache's own dtype)."""
    return kvs["k"], kvs["v"]
