"""Device half of the paged KV subsystem: the pool-shaped cache tensors and
the writes and reads the batched engine makes through the page tables.

Counterpart of dnet_tpu/kv/store.py (`BlockStore`, its gather, scatter,
commit and append programs).  The pool reuses the dense cache layout with
the batch axis as the block axis: `model.init_kv(L, pool_blocks,
block_tokens, dtype, quant_bits)` gives leaves [L, N_blocks, bt, KVH, Hd]
on the engine's device, and a quantized pool (`quant_bits` 8 or 4) carries
its f32 scale leaves [L, N_blocks, bt, KVH, 1] beside the codes: every op
here walks all leaves, so scales travel with their codes.  A model with a
paired cache (gpt_oss's {"a": cache, "b": cache}) gives a nested tree,
walked the same way.

- **gather** (the dense-gather decode): [slots, nb] table ids give a fresh
  contiguous [L, slots, nb * bt, ...] view of every leaf, which the dense
  batched step reads and writes as if it were dense slots.  Table entries
  past a slot's blocks are 0 (block 0's rows), at positions no lane's
  length reaches.
- **scatter** writes back only the blocks a step touched, as (slot,
  logical block, physical block) triples.
- **commit_row / gather_row** move one staged sequence's blocks between a
  dense [L, 1, S, ...] row and the pool; **append_rows** is the ragged
  path's one-row-per-lane write.

The reference gathers and scatters outside any kernel (XLA take and
.at[].set), and so does this: plain tensor indexing, over each block
viewed as 8-byte words (`_words`), so the index copy moves a word a thread
where it would move one 2-byte value.  Where JAX drops an
inactive lane's append by passing an out-of-range block with
`mode="drop"`, PyTorch indexing has no drop mode: an out-of-range index
raises and a negative one wraps onto a live block.  So only active lanes'
blocks are ever listed, and every index is checked before it is written.

The session-layout probe (`session_tokens`) refuses what the pool cannot
address with `NotImplementedError`, as the reference does: a session cache
whose leaves are not [L, 1, session_tokens, ...] (gpt_oss's W-row rings,
where the slot of position p is p % W).  The batched engine then serves
dense slots.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from dnet_tpu_torch.kv.paged import PagedKVConfig

Path = Tuple[str, ...]


def tree_leaves(tree: dict, prefix: Path = ()) -> Iterator[Tuple[Path, torch.Tensor]]:
    """(path, tensor) of every leaf of a cache tree, in insertion order."""
    for name, val in tree.items():
        if isinstance(val, dict):
            yield from tree_leaves(val, prefix + (name,))
        else:
            yield prefix + (name,), val


def tree_get(tree: dict, path: Path) -> torch.Tensor:
    for name in path:
        tree = tree[name]
    return tree


def _words(t: torch.Tensor, lead: int) -> torch.Tensor:
    """A contiguous tensor's view [*t.shape[:lead], words]: the trailing
    dims as one row of the widest integer words that divide its bytes."""
    row = t.reshape(*t.shape[:lead], -1)
    nbytes = row.shape[-1] * t.element_size()
    word = next(w for w in (torch.int64, torch.int32, torch.int16, torch.uint8) if nbytes % w.itemsize == 0)
    return row.view(word)


def tree_from(items: Sequence[Tuple[Path, torch.Tensor]]) -> dict:
    """The tree whose leaves are `items` (the inverse of tree_leaves)."""
    out: dict = {}
    for path, val in items:
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = val
    return out


class BlockStore:
    """Pool-shaped KV tensors: leaves [L, N_blocks, bt, ...] (+ scales)."""

    def __init__(
        self, model, n_layers: int, cfg: PagedKVConfig, kv_dtype: str, quant_bits: int = 0,
        session_tokens: int = 0,
    ) -> None:
        self.cfg = cfg
        self.block_tokens = cfg.block_tokens
        if session_tokens:
            # probed first, so a refused layout allocates no pool
            probe = model.init_kv(n_layers, 1, session_tokens, kv_dtype, quant_bits)
            for path, leaf in tree_leaves(probe):
                if leaf.dim() < 3 or leaf.shape[1] != 1 or leaf.shape[2] != session_tokens:
                    raise NotImplementedError(
                        "paged KV needs slot-addressed max_seq session caches; got session leaf "
                        f"{'/'.join(path)} of shape {tuple(leaf.shape)} (rotating ring buffers stay dense)"
                    )
            del probe
        self.kv: dict = model.init_kv(n_layers, cfg.pool_blocks, cfg.block_tokens, kv_dtype, quant_bits)
        for path, leaf in tree_leaves(self.kv):
            if leaf.dim() < 3 or leaf.shape[1] != cfg.pool_blocks or leaf.shape[2] != cfg.block_tokens:
                # a model with per-kind cache shapes cannot use the batch axis as blocks
                raise NotImplementedError(
                    "paged KV needs the flat [L, B, S, ...] cache layout; got leaf "
                    f"{'/'.join(path)} of shape {tuple(leaf.shape)}"
                )
        self.device = next(tree_leaves(self.kv))[1].device

    def _index(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, dtype=np.int64)).to(self.device, non_blocking=True)

    # ---- the dense-gather decode ---------------------------------------
    def gather(self, ids: np.ndarray) -> dict:
        """A fresh contiguous [L, slots, nb * bt, ...] view of the tables in
        `ids` ([slots, nb] physical block ids, 0 past each table)."""
        ids = np.asarray(ids)
        if ids.ndim != 2:
            raise ValueError(f"table ids must be [slots, nb], got shape {ids.shape}")
        self._check_blocks(ids.reshape(-1))
        idx = self._index(ids)
        s, nb = ids.shape
        bt = self.block_tokens
        out = []
        for path, pool in tree_leaves(self.kv):
            g = _words(pool, 2)[:, idx].view(pool.dtype)  # [L, slots, nb, block's values]
            out.append((path, g.reshape(pool.shape[0], s, nb * bt, *pool.shape[3:])))
        return tree_from(out)

    def scatter(self, dense: dict, triples: Sequence[Tuple[int, int, int]]) -> None:
        """Persist touched blocks of a dense view ([L, slots, S, ...]): for
        each (slot, logical block, physical block) triple, the view's rows
        [b * bt, (b + 1) * bt) of that slot go to the pool block.  Each
        physical block may be listed once."""
        if not triples:
            return
        slot_idx, block_idx, phys = (list(col) for col in zip(*triples))
        if len(set(phys)) != len(phys):
            raise ValueError(f"physical blocks {phys} listed more than once")
        self._check_blocks(phys)
        bt = self.block_tokens
        first = next(tree_leaves(dense))[1]
        s, S = first.shape[1], first.shape[2]
        if S % bt:
            raise ValueError(f"a view of {S} rows is not whole blocks of {bt}")
        if any(not 0 <= i < s for i in slot_idx) or any(not 0 <= b < S // bt for b in block_idx):
            raise ValueError(f"triples {list(triples)} outside a view of {s} slots x {S // bt} blocks")
        si, bi, pb = self._index(slot_idx), self._index(block_idx), self._index(phys)
        for path, pool in tree_leaves(self.kv):
            d = tree_get(dense, path).to(pool.dtype)
            blocks = d.reshape(d.shape[0], d.shape[1], S // bt, bt, *d.shape[3:])
            _words(pool, 2)[:, pb] = _words(blocks, 3)[:, si, bi]  # [L, K, words] into the pool's own storage

    # ---- one sequence's staging row -----------------------------------
    def commit_row(
        self, kv_row: dict, logical_blocks: Sequence[int], phys_blocks: Sequence[int],
    ) -> None:
        """Persist blocks of a single-sequence dense row ([L, 1, S, ...]):
        logical block i of the row goes to pool block phys_blocks[i]."""
        if len(logical_blocks) != len(phys_blocks):
            raise ValueError(f"{len(logical_blocks)} logical blocks for {len(phys_blocks)} physical")
        self.scatter(kv_row, [(0, lb, pb) for lb, pb in zip(logical_blocks, phys_blocks)])

    def gather_row(self, blocks: Sequence[int], width_tokens: int) -> dict:
        """One sequence's blocks as a fresh dense row [L, 1, width_tokens,
        ...] (logical block i from pool block blocks[i]); rows past the
        blocks are zeros, beyond every position the row's prefill attends."""
        bt = self.block_tokens
        if width_tokens % bt or len(blocks) * bt > width_tokens:
            raise ValueError(f"{len(blocks)} blocks of {bt} tokens in a row of {width_tokens}")
        self._check_blocks(blocks)
        n = len(blocks) * bt
        idx = self._index(blocks)
        out = []
        for path, pool in tree_leaves(self.kv):
            L, tail = pool.shape[0], pool.shape[3:]
            row = torch.zeros((L, 1, width_tokens, *tail), dtype=pool.dtype, device=pool.device)
            if n:
                row[:, 0, :n] = pool[:, idx].reshape(L, n, *tail)
            out.append((path, row))
        return tree_from(out)

    # ---- the ragged path ------------------------------------------------
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
        for path, pool in tree_leaves(self.kv):
            pool[:, idx_phys, idx_off] = tree_get(rows, path)[:, idx_lane].to(pool.dtype)

    def _check_blocks(self, blocks) -> None:
        n = self.cfg.pool_blocks
        b = np.asarray(blocks, dtype=np.int64)
        if b.size and (b.min() < 0 or b.max() >= n):
            raise ValueError(f"pool blocks {b.tolist()} outside [0, {n})")
