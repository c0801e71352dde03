"""Block-level prefix sharing over the paged pool.

Counterpart of dnet_tpu/kv/prefix.py `PagedPrefixCache`: the `PrefixIndex`
matcher (core/prefix_cache.py) resolves hits to refcounted block runs in
the pool instead of dense KV snapshots.

- **store dedup**: a snapshot whose prompt extends an existing entry
  aliases the parent's full blocks (ref++) and commits only its own tail
  blocks, so turn N's snapshot costs O(new turn), not O(history).
- **adoption** (`lookup_blocks`): the batched engine's page tables alias an
  entry's full blocks directly, with no copy; the partial tail block (a
  request diverging mid-block) is copied by the adopter (copy-on-write).
- **live-table snapshots** (`store_blocks`): an adopted slot's table is
  aliased whole, zero copies.

Entry eviction releases the entry's references through PrefixIndex's
`on_evict` hook; the blocks live until the last page table drops them.
The reference's dense facade `lookup` (a restored row for the
single-sequence engine's paged mode) and the fleet's
`prefix_affinity_key` are not ported; `store` keeps the facade's name for
the one caller the scheduler has, a prompt still staged as a dense row.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from dnet_tpu_torch.core.prefix_cache import PrefixIndex
from dnet_tpu_torch.kv.paged import BlockPool, KVPoolExhausted
from dnet_tpu_torch.kv.store import BlockStore
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


class PagedPrefixCache:
    """PrefixIndex entries valued (n_tokens, block run) in a shared pool."""

    def __init__(self, pool: BlockPool, store: BlockStore, capacity: int, min_tokens: int = 16) -> None:
        self.pool = pool
        self._dev = store
        self._index = PrefixIndex(capacity, min_tokens, on_evict=self._release)
        self.stats = {"hits": 0, "misses": 0, "stores": 0}

    @property
    def min_tokens(self) -> int:
        return self._index.min_tokens

    @min_tokens.setter
    def min_tokens(self, v: int) -> None:
        self._index.min_tokens = v

    def __len__(self) -> int:
        return len(self._index)

    def held_blocks(self) -> int:
        """Distinct pool blocks the entries hold (aliased ones once)."""
        return len({b for _n, blocks in self._index.values() for b in blocks})

    def _release(self, value) -> None:
        _n, blocks = value
        self.pool.free_blocks(blocks)

    def lookup_blocks(self, prompt_ids: Sequence[int]) -> Optional[Tuple[int, List[int], int]]:
        """Longest-prefix hit as (n_tokens, blocks, n_full).  The first
        `n_full` blocks are full and aliased (counted shared); a trailing
        partial block (n % block_tokens != 0) is retained uncounted: the
        adopter copies it before writing and drops the transient reference
        afterwards.  The caller owns one reference on every returned block."""
        hit = self._index.lookup(prompt_ids)
        if hit is None:
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        n, (n_entry, blocks) = hit
        assert n == n_entry
        n_full = n // self.pool.block_tokens
        out = self.pool.share(blocks[:n_full])
        out += self.pool.retain(blocks[n_full:])
        return n, out, n_full

    def store_blocks(self, prompt_ids: Sequence[int], n_tokens: int, blocks: Sequence[int]) -> bool:
        """Snapshot a live page table by aliasing its blocks (zero copies).
        Safe because rows < n_tokens of every aliased block never change:
        the owning slot only writes its partial tail block's rows >=
        n_tokens, and adopters copy that block before writing."""
        ids = list(prompt_ids)
        if len(ids) < self.min_tokens or n_tokens != len(ids):
            return False
        if self._index.get_exact(ids) is not None:
            return False
        nb = self.pool.cfg.blocks_for(n_tokens)
        entry = self.pool.share(list(blocks[:nb]))
        if not self._index.put(ids, (n_tokens, entry)):
            self.pool.free_blocks(entry)
            return False
        self.stats["stores"] += 1
        return True

    def store(self, prompt_ids: Sequence[int], kv_row: dict) -> None:
        """Snapshot a dense staging row ([L, 1, S, ...]), committing only the
        tail blocks a parent entry does not already hold (block-level
        dedup).  A full pool skips the snapshot, never the request."""
        ids = list(prompt_ids)
        n = len(ids)
        if n < self.min_tokens:
            return
        if self._index.get_exact(ids) is not None:
            return
        bt = self.pool.block_tokens
        nb = self.pool.cfg.blocks_for(n)
        parent = self._index.match_quiet(ids, allow_equal=False)
        n_parent_full = (parent[0] // bt) if parent is not None else 0
        try:
            own = self.pool.alloc(nb - n_parent_full)
        except KVPoolExhausted as exc:
            log.warning("paged prefix store skipped: %s", exc)
            return
        aliased = self.pool.share(parent[1][1][:n_parent_full]) if parent is not None else []
        self._dev.commit_row(kv_row, list(range(n_parent_full, nb)), own)
        entry = aliased + own
        if self._index.put(ids, (n, entry)):
            self.stats["stores"] += 1
        else:
            self.pool.free_blocks(entry)

    def clear(self) -> None:
        self._index.clear()  # on_evict releases every entry's blocks
