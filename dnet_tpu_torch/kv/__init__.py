"""Paged KV: the block pool, page tables and the pool's device tensors.

Counterpart of dnet_tpu/kv/, with the paged prefix cache (`kv/prefix.py`).
"""

from dnet_tpu_torch.kv.paged import (
    BlockPool,
    KVPoolExhausted,
    PagedKVConfig,
    PageTable,
    paged_enabled,
    ragged_enabled,
)
from dnet_tpu_torch.kv.prefix import PagedPrefixCache
from dnet_tpu_torch.kv.store import BlockStore

__all__ = [
    "BlockPool",
    "BlockStore",
    "KVPoolExhausted",
    "PagedKVConfig",
    "PageTable",
    "PagedPrefixCache",
    "paged_enabled",
    "ragged_enabled",
]
