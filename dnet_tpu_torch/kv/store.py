"""Device half of the paged KV subsystem: the pool-shaped cache tensors and
the two writes the ragged decode path makes into them.

Counterpart of dnet_tpu/kv/store.py (`BlockStore`, its commit and append
programs).  The pool reuses the dense cache layout with the batch axis as the
block axis: `model.init_kv(L, pool_blocks, block_tokens)` gives k/v tensors
[L, N_blocks, bt, KVH, Hd] in the KV dtype on the engine's device.  Both
writes update the pool in place (the reference donates the buffers to jitted
programs for the same effect).

The ragged path needs no gather: decode reads the pool through the page
tables in the kernel itself (ops/paged_attention.py).  A prefix-cache hit
gathers its blocks once into the dense staging row its prefill continues
from (`gather_row`).

Where JAX drops an inactive lane's append by passing an out-of-range block
with `mode="drop"`, PyTorch indexing has no drop mode: an out-of-range index
raises and a negative one wraps onto a live block.  So `append_rows` is
given the active lanes only, and checks every index before it writes.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from dnet_tpu_torch.kv.paged import PagedKVConfig


class BlockStore:
    """Pool-shaped KV tensors: {"k", "v"} -> [L, N_blocks, bt, KVH, Hd]."""

    def __init__(self, model, n_layers: int, cfg: PagedKVConfig, kv_dtype: str) -> None:
        self.cfg = cfg
        self.block_tokens = cfg.block_tokens
        self.kv: Dict[str, torch.Tensor] = model.init_kv(
            n_layers, cfg.pool_blocks, cfg.block_tokens, kv_dtype
        )
        self.device = self.kv["k"].device

    def _index(self, ids: Sequence[int]) -> torch.Tensor:
        return torch.tensor(list(ids), dtype=torch.long).to(self.device, non_blocking=True)

    def commit_row(
        self, kv_row: Dict[str, torch.Tensor], logical_blocks: Sequence[int],
        phys_blocks: Sequence[int],
    ) -> None:
        """Persist blocks of a single-sequence dense row ([L, 1, S, ...]):
        logical block i of the row goes to pool block phys_blocks[i]."""
        if len(logical_blocks) != len(phys_blocks):
            raise ValueError(f"{len(logical_blocks)} logical blocks for {len(phys_blocks)} physical")
        if not phys_blocks:
            return
        self._check_blocks(phys_blocks)
        bt = self.block_tokens
        lb, pb = self._index(logical_blocks), self._index(phys_blocks)
        for name, pool in self.kv.items():
            row = kv_row[name][:, 0]  # [L, S, KVH, Hd]
            L, S = row.shape[:2]
            blocks = row.reshape(L, S // bt, bt, *row.shape[2:])
            pool[:, pb] = blocks[:, lb].to(pool.dtype)

    def gather_row(self, blocks: Sequence[int], width_tokens: int) -> Dict[str, torch.Tensor]:
        """One sequence's blocks as a fresh dense row [L, 1, width_tokens,
        ...] (logical block i from pool block blocks[i]); rows past the
        blocks are zeros, beyond every position the row's prefill attends."""
        bt = self.block_tokens
        if width_tokens % bt or len(blocks) * bt > width_tokens:
            raise ValueError(f"{len(blocks)} blocks of {bt} tokens in a row of {width_tokens}")
        self._check_blocks(blocks)
        n = len(blocks) * bt
        idx = self._index(blocks)
        out = {}
        for name, pool in self.kv.items():
            L, tail = pool.shape[0], pool.shape[3:]
            row = torch.zeros((L, 1, width_tokens, *tail), dtype=pool.dtype, device=pool.device)
            if n:
                row[:, 0, :n] = pool[:, idx].reshape(L, n, *tail)
            out[name] = row
        return out

    def append_rows(
        self, rows: Dict[str, torch.Tensor], lanes: Sequence[int], phys: Sequence[int],
        off: Sequence[int],
    ) -> None:
        """One new token row per ACTIVE lane, written in place: rows leaves
        [L, slots, KVH, Hd] (one step's stacked per-layer k/v), and for the
        k-th active lane `lanes[k]` its row goes to pool block phys[k] at
        in-block offset off[k].  Lanes not listed are not written."""
        if not (len(lanes) == len(phys) == len(off)):
            raise ValueError(f"lanes/phys/off lengths differ: {len(lanes)}, {len(phys)}, {len(off)}")
        if not lanes:
            return
        self._check_blocks(phys)
        if any(not 0 <= o < self.block_tokens for o in off):
            raise ValueError(f"in-block offsets {list(off)} outside [0, {self.block_tokens})")
        idx_lane, idx_phys, idx_off = self._index(lanes), self._index(phys), self._index(off)
        for name, pool in self.kv.items():
            pool[:, idx_phys, idx_off] = rows[name][:, idx_lane].to(pool.dtype)

    def _check_blocks(self, blocks: Sequence[int]) -> None:
        n = self.cfg.pool_blocks
        if any(not 0 <= int(b) < n for b in blocks):
            raise ValueError(f"pool blocks {list(blocks)} outside [0, {n})")
