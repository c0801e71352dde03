"""Prefix matching for KV reuse across requests.

Counterpart of dnet_tpu/core/prefix_cache.py: `PrefixIndex`, the matcher
and LRU that the paged prefix cache (kv/prefix.py) stores block runs in,
and `PrefixCache`, the dense snapshot cache of the single-sequence engine
and of dense batched slots (the KV of whole prompts).  Matching is
exact-prefix over full stored prompts, so the win is multi-turn chat: a
follow-up request resends the grown history, hits the previous turn's
entry and prefills only the new turn.  Snapshots are clones both in and
out: the engine writes its caches in place, so a shared tensor would
change under the entry at the borrowing session's next step.
`SnapshotStore` is the shard's half of ring prefix caching: the API keys
each snapshot through the prompt frames (it alone sees token ids), and a
shard keeps its own window's KV under that key, cloned in and out as
well.  `PrefixIndex` counts its hits, misses, stores and evictions in
the reference's dnet_kv_cache_*_total{cache} families (`cache` = its
`kind`, "prefix" for both caches, as the reference's) and in `stats`;
`SnapshotStore` counts under `cache="snapshot"`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch

from dnet_tpu_torch.obs import metric

_HITS = metric("dnet_kv_cache_hits_total")
_MISSES = metric("dnet_kv_cache_misses_total")
_EVICTIONS = metric("dnet_kv_cache_evictions_total")
_STORES = metric("dnet_kv_cache_stores_total")


def clone_tree(tree):
    """A deep copy of a cache: a tensor, or a dict / list of them."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return [clone_tree(v) for v in tree]


class PrefixIndex:
    """Longest-strict-proper-prefix matcher + LRU over token-id tuples: the
    one owner of the matching invariants (at least 1 token must remain to
    prefill, so the forward pass produces the last position's logits;
    move-to-end on a hit; evict the oldest at capacity; prompts shorter
    than `min_tokens` are not stored)."""

    def __init__(self, capacity: int, min_tokens: int = 16, on_evict=None, kind: str = "prefix") -> None:
        self.capacity = capacity
        self.min_tokens = min_tokens
        self.kind = kind  # the `cache` label of its counters
        # called with each evicted value after the lock drops (the paged
        # prefix cache releases its block references here)
        self.on_evict = on_evict
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[int, ...], object]" = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "stores": 0, "evictions": 0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def values(self) -> list:
        with self._lock:
            return list(self._entries.values())

    def _match(self, ids: Tuple[int, ...], max_len: int):
        """Longest entry of length <= max_len that prefixes `ids` (the
        caller holds the lock)."""
        best = None
        for key in self._entries:
            if len(key) < (best and len(best) or 1):
                continue
            if len(key) <= max_len and ids[: len(key)] == key:
                if best is None or len(key) > len(best):
                    best = key
        return best

    def lookup(self, prompt_ids: Sequence[int]) -> Optional[Tuple[int, object]]:
        """Longest entry covering at most len(prompt) - 1 tokens, LRU-bumped:
        (n_tokens, value) or None.  Counts the hit or miss."""
        ids = tuple(prompt_ids)
        with self._lock:
            best = self._match(ids, len(ids) - 1)
            if best is None:
                self.stats["misses"] += 1
                _MISSES.labels(cache=self.kind).inc()
                return None
            self._entries.move_to_end(best)
            self.stats["hits"] += 1
            _HITS.labels(cache=self.kind).inc()
            return len(best), self._entries[best]

    def match_quiet(
        self, prompt_ids: Sequence[int], allow_equal: bool = True
    ) -> Optional[Tuple[int, object]]:
        """Longest-prefix match without touching the counters or the LRU
        order (the store side's dedup probe is not a request-path hit)."""
        ids = tuple(prompt_ids)
        with self._lock:
            best = self._match(ids, len(ids) if allow_equal else len(ids) - 1)
            if best is None:
                return None
            return len(best), self._entries[best]

    def get_exact(self, prompt_ids: Sequence[int]):
        """The exact match's value (LRU-bumped) or None."""
        ids = tuple(prompt_ids)
        with self._lock:
            if ids not in self._entries:
                return None
            self._entries.move_to_end(ids)
            return self._entries[ids]

    def put(self, prompt_ids: Sequence[int], value) -> bool:
        """Insert if absent and long enough; True iff newly stored."""
        ids = tuple(prompt_ids)
        if len(ids) < self.min_tokens:
            return False
        evicted = []
        with self._lock:
            if ids in self._entries:
                self._entries.move_to_end(ids)
                return False
            self._entries[ids] = value
            self.stats["stores"] += 1
            _STORES.labels(cache=self.kind).inc()
            while len(self._entries) > self.capacity:
                evicted.append(self._entries.popitem(last=False)[1])
                self.stats["evictions"] += 1
                _EVICTIONS.labels(cache=self.kind).inc()
        if self.on_evict is not None:
            for v in evicted:
                self.on_evict(v)
        return True

    def clear(self) -> None:
        with self._lock:
            dropped = list(self._entries.values())
            self._entries.clear()
        if self.on_evict is not None:
            for v in dropped:
                self.on_evict(v)


class PrefixCache:
    """Full-prompt KV snapshots over a PrefixIndex (repetition counts are
    zero at prefill end, since they track generated tokens only, so the KV
    is the whole state)."""

    def __init__(self, capacity: int, min_tokens: int = 16) -> None:
        self._index = PrefixIndex(capacity, min_tokens)
        self.stats = {"hits": 0, "misses": 0, "stores": 0}

    @property
    def min_tokens(self) -> int:
        return self._index.min_tokens

    @min_tokens.setter
    def min_tokens(self, v: int) -> None:  # tests tune it for tiny prompts
        self._index.min_tokens = v

    def __len__(self) -> int:
        return len(self._index)

    def lookup(self, prompt_ids: Sequence[int]) -> Optional[Tuple[int, object]]:
        """The longest cached prefix covering at most len(prompt) - 1
        tokens: (n_tokens, a private copy of its KV) or None."""
        hit = self._index.lookup(prompt_ids)
        if hit is None:
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        n, kv = hit
        return n, clone_tree(kv)

    def store(self, prompt_ids: Sequence[int], kv) -> None:
        """Snapshot a copy of `kv` under the full prompt (prompts shorter
        than min_tokens and ones already stored are skipped)."""
        if len(prompt_ids) < self.min_tokens or self._index.get_exact(prompt_ids) is not None:
            return
        if self._index.put(prompt_ids, clone_tree(kv)):
            self.stats["stores"] += 1

    def clear(self) -> None:
        self._index.clear()


class SnapshotStore:
    """String-keyed LRU of (pos, KV snapshot), `capacity` entries: the shard
    side of ring prefix caching.  A snapshot is a clone of the session's
    cache when stored and again when handed out, so neither the storing
    session's later decode nor a seeded session's writes reach it."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Tuple[int, object]]" = OrderedDict()
        self.stats = {"hits": 0, "misses": 0, "stores": 0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: str) -> Optional[Tuple[int, object]]:
        """(pos, a private copy of the snapshot) or None; counts the hit or
        miss and LRU-bumps a hit."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.stats["misses"] += 1
                _MISSES.labels(cache="snapshot").inc()
                return None
            self._entries.move_to_end(key)
            self.stats["hits"] += 1
            _HITS.labels(cache="snapshot").inc()
            n, kv = hit
        return n, clone_tree(kv)

    def put(self, key: str, pos: int, kv) -> None:
        """Store a copy of `kv` (covering `pos` tokens) under `key`, unless
        the key is held already (then only LRU-bumped); evicts the oldest
        past capacity."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return
            self._entries[key] = (pos, clone_tree(kv))
            self.stats["stores"] += 1
            _STORES.labels(cache="snapshot").inc()
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                _EVICTIONS.labels(cache="snapshot").inc()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
