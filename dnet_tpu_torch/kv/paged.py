"""Paged KV block-pool allocator: free list, page tables, refcounts.

Counterpart of dnet_tpu/kv/paged.py.  The host-side half of the paged KV
subsystem: a `BlockPool` (allocation, refcounts, exact accounting, typed
backpressure) and per-sequence `PageTable`s mapping logical block index to
physical pool block.  The device half (`kv/store.py`) holds the pool-shaped
cache tensors.  Everything here is plain Python under one lock.

The pool publishes its state as the reference's metric families
(dnet_kv_blocks_used / _free, dnet_kv_pool_blocks, dnet_kv_cow_copies_total,
dnet_kv_prefix_shared_blocks_total, dnet_kv_admission_rejected_total) and
keeps the same numbers as counters of its own for /health (`used`, `free`,
`peak_used`, `cow_copies`, `shared_blocks`, `admission_rejected`).  Refcounts, `retain`, `share` and
`cow` serve the paged prefix cache (kv/prefix.py), whose entries alias the
blocks of live page tables.

Invariants (`check_conservation`):
- ``used + free == total`` at every step; a block shared by N holders counts
  once in used.
- every allocated block's refcount equals the number of holders that will
  eventually free it.
- exhaustion raises `KVPoolExhausted`, a backpressure signal the serving
  layer maps to HTTP 429, never a shape error or an out-of-memory crash.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from dnet_tpu_torch.config import kv_settings
from dnet_tpu_torch.obs import metric

_USED = metric("dnet_kv_blocks_used")
_FREE = metric("dnet_kv_blocks_free")
_POOL = metric("dnet_kv_pool_blocks")
_COW = metric("dnet_kv_cow_copies_total")
_SHARED = metric("dnet_kv_prefix_shared_blocks_total")
_REJECTED = metric("dnet_kv_admission_rejected_total")


class KVPoolExhausted(RuntimeError):
    """The paged pool cannot cover an admission or an extension."""

    def __init__(self, need: int, free: int, total: int) -> None:
        super().__init__(
            f"paged KV pool exhausted: need {need} block(s), "
            f"{free} free of {total}"
        )
        self.need = need
        self.free = free
        self.total = total


def ceil_div(n: int, d: int) -> int:
    return -(-n // d)


@dataclass(frozen=True)
class PagedKVConfig:
    """Pool geometry, resolved from DNET_KV_* settings by the engines."""

    block_tokens: int
    pool_blocks: int

    def __post_init__(self) -> None:
        if self.block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {self.block_tokens}")
        if self.pool_blocks < 1:
            raise ValueError(f"pool_blocks must be >= 1, got {self.pool_blocks}")

    @classmethod
    def from_settings(cls, max_seq: int, slots: int = 1) -> "PagedKVConfig":
        """Block and pool sizes from KVSettings; pool_blocks=0 sizes the pool
        to the dense equivalent (slots x max_seq worth of blocks), so paging
        never admits less than dense slots would."""
        kv = kv_settings()
        bt = int(kv.block_tokens)
        if bt < 1 or max_seq % bt:
            raise ValueError(
                f"DNET_KV_BLOCK_TOKENS={bt} must be >= 1 and divide "
                f"max_seq={max_seq}"
            )
        pool = int(kv.pool_blocks) or slots * ceil_div(max_seq, bt)
        return cls(block_tokens=bt, pool_blocks=pool)

    def blocks_for(self, n_tokens: int) -> int:
        return ceil_div(n_tokens, self.block_tokens)


@dataclass
class PageTable:
    """One sequence's logical->physical block map: `blocks[i]` backs tokens
    [i*bt, (i+1)*bt)."""

    blocks: List[int] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.blocks)


class BlockPool:
    """Fixed-capacity block allocator with refcounts and exact accounting."""

    def __init__(self, cfg: PagedKVConfig) -> None:
        self.cfg = cfg
        self.block_tokens = cfg.block_tokens
        self.total = cfg.pool_blocks
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.total))
        self._ref: Dict[int, int] = {}
        # counters (the reference's gauges): high-water mark of used blocks,
        # COW copies, blocks aliased by share(), refused admissions
        self.peak_used = 0
        self.cow_copies = 0
        self.shared_blocks = 0
        self.admission_rejected = 0
        _POOL.set(self.total)
        self._publish()

    # ---- accounting ---------------------------------------------------
    @property
    def used(self) -> int:
        with self._lock:
            return len(self._ref)

    @property
    def free(self) -> int:
        with self._lock:
            return len(self._free)

    def _note_peak(self) -> None:
        # caller holds _lock
        self.peak_used = max(self.peak_used, len(self._ref))

    def _publish(self) -> None:
        """Set the used / free gauges (the two may tear between reads; each
        is consistent)."""
        with self._lock:
            used, free = len(self._ref), len(self._free)
        _USED.set(used)
        _FREE.set(free)

    def can_cover(self, n_blocks: int) -> bool:
        with self._lock:
            return len(self._free) >= n_blocks

    def require(self, n_blocks: int) -> None:
        """Admission pre-check: raise KVPoolExhausted (and count the
        rejection) if the pool cannot cover n_blocks now, before a prefill
        burns any compute."""
        with self._lock:
            free = len(self._free)
            if free < n_blocks:
                self.admission_rejected += 1
        if free < n_blocks:
            _REJECTED.inc()
            raise KVPoolExhausted(n_blocks, free, self.total)

    # ---- allocation ---------------------------------------------------
    def alloc(self, n_blocks: int) -> List[int]:
        """Allocate n fresh blocks (ref=1 each) or raise KVPoolExhausted
        without a partial allocation."""
        if n_blocks == 0:
            return []
        with self._lock:
            if len(self._free) < n_blocks:
                free = len(self._free)
                self.admission_rejected += 1
                _REJECTED.inc()
                raise KVPoolExhausted(n_blocks, free, self.total)
            out = [self._free.pop() for _ in range(n_blocks)]
            for b in out:
                self._ref[b] = 1
            self._note_peak()
        self._publish()
        return out

    def retain(self, blocks: Sequence[int]) -> List[int]:
        """Take one extra reference per block, not counted as sharing (a
        transient hold, e.g. a prefix entry's partial tail block while an
        adopter copies it)."""
        with self._lock:
            for b in blocks:
                if b not in self._ref:
                    raise ValueError(f"retain of unallocated block {b}")
                self._ref[b] += 1
        return list(blocks)

    def share(self, blocks: Sequence[int]) -> List[int]:
        """Alias existing blocks (ref++ each); returns them for chaining.
        Counted in `shared_blocks`: each is a copy the dense path would make."""
        out = self.retain(blocks)
        with self._lock:
            self.shared_blocks += len(out)
        if out:
            _SHARED.inc(len(out))
        return out

    def count_cow(self, n: int = 1) -> None:
        """Count copies-on-write made outside `cow()` (a shared partial
        block whose merged contents commit from a dense staging row)."""
        with self._lock:
            self.cow_copies += n
        if n > 0:
            _COW.inc(n)

    def free_blocks(self, blocks: Sequence[int]) -> int:
        """Drop one reference per block; blocks reaching ref 0 return to the
        free list.  Returns how many became free."""
        if not blocks:
            return 0
        released = 0
        with self._lock:
            for b in blocks:
                r = self._ref.get(b)
                if r is None:
                    raise ValueError(f"free of unallocated block {b}")
                if r == 1:
                    del self._ref[b]
                    self._free.append(b)
                    released += 1
                else:
                    self._ref[b] = r - 1
        self._publish()
        return released

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref.get(block, 0)

    def cow(self, block: int) -> int:
        """Copy-on-write: a fresh block replaces a shared one this sequence
        is about to diverge into; the caller copies the device contents and
        this drops its reference on the old block.  Returns the new id."""
        new = self.alloc(1)[0]
        self.free_blocks([block])
        with self._lock:
            self.cow_copies += 1
        _COW.inc()
        return new

    # ---- table helpers ------------------------------------------------
    def ensure(self, table: PageTable, n_tokens: int) -> List[int]:
        """Grow `table` to cover n_tokens (appending fresh blocks); returns
        the appended ids.  All or nothing on exhaustion."""
        need = self.cfg.blocks_for(n_tokens) - len(table.blocks)
        if need <= 0:
            return []
        fresh = self.alloc(need)
        table.blocks.extend(fresh)
        return fresh

    def release_table(self, table: Optional[PageTable]) -> int:
        if table is None or not table.blocks:
            return 0
        n = self.free_blocks(table.blocks)
        table.blocks.clear()
        return n

    # ---- invariants ---------------------------------------------------
    def check_conservation(self, holders: Optional[Sequence[Sequence[int]]] = None) -> None:
        """Assert the books balance: used + free == total, the free list is
        duplicate-free and disjoint from allocated blocks, and -- when the
        caller passes every live holder's block list -- refcounts equal the
        number of holders per block."""
        with self._lock:
            used = len(self._ref)
            free = list(self._free)
            refs = dict(self._ref)
        if used + len(free) != self.total:
            raise AssertionError(
                f"paged pool leak: used {used} + free {len(free)} != total {self.total}"
            )
        if len(set(free)) != len(free):
            raise AssertionError("paged pool free list has duplicates")
        if set(free) & set(refs):
            raise AssertionError("paged pool free list overlaps allocated blocks")
        if any(r < 1 for r in refs.values()):
            raise AssertionError("paged pool holds a block with refcount < 1")
        if holders is not None:
            counts: Dict[int, int] = {}
            for blocks in holders:
                for b in blocks:
                    counts[b] = counts.get(b, 0) + 1
            if counts != refs:
                raise AssertionError(f"paged pool refcounts {refs} != holder counts {counts}")


def paged_enabled() -> bool:
    """DNET_KV_PAGED=1: per-slot page tables over a shared block pool."""
    return kv_settings().paged


def ragged_enabled() -> bool:
    """DNET_KV_RAGGED=1: decode attends the block pool in place through the
    page tables (ops/paged_attention.py).  Only meaningful under paged KV."""
    return kv_settings().ragged
