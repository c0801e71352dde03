"""The port's paged prefix cache (kv/prefix.py) against dnet_tpu's.

Both packages run the same operation sequences on pools of the same
geometry, with the same numpy KV rows: stores that dedup against a parent
entry's full blocks, live-table snapshots, hits that alias full blocks
and retain a partial tail, LRU eviction that releases references, a store
the pool cannot cover, and a clear.  After every operation the two pools
hold the same blocks with the same refcounts (both allocate from the top
of the free list), both balance their books, and a hit's gathered row
equals the reference's (rows below the hit's length)."""

import numpy as np
import pytest
import torch

from dnet_tpu.kv import BlockPool as RefPool
from dnet_tpu.kv import BlockStore as RefStore
from dnet_tpu.kv import PagedKVConfig as RefCfg
from dnet_tpu.kv import PagedPrefixCache as RefCache
from dnet_tpu_torch.core.prefix_cache import PrefixIndex
from dnet_tpu_torch.kv import BlockPool, BlockStore, PagedKVConfig, PagedPrefixCache

L, KVH, HD, BT, ROW = 2, 2, 4, 4, 32


class _RefModel:
    def init_kv(self, n_layers, batch, max_seq, dtype="float32", quant_bits=0, rotating=True):
        from dnet_tpu.core.kvcache import KVConfig, init_cache

        return init_cache(KVConfig(n_layers, batch, max_seq, n_kv_heads=KVH, head_dim=HD, dtype=dtype))


class _PortModel:
    def init_kv(self, n_layers, batch, max_seq, dtype="float32", quant_bits=0):
        shape = (n_layers, batch, max_seq, KVH, HD)
        return {"k": torch.zeros(shape), "v": torch.zeros(shape)}


def _rows(seed):
    """A dense [L, 1, ROW, KVH, HD] row, distinct values per token."""
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=(L, 1, ROW, KVH, HD)).astype(np.float32) for n in ("k", "v")}


class _Pair:
    """The same cache in both packages, driven op by op."""

    def __init__(self, pool_blocks=16, capacity=4, min_tokens=4):
        import jax.numpy as jnp

        self.jnp = jnp
        self.rp = RefPool(RefCfg(block_tokens=BT, pool_blocks=pool_blocks))
        self.rs = RefStore(_RefModel(), L, RefCfg(block_tokens=BT, pool_blocks=pool_blocks), "float32")
        self.rc = RefCache(self.rp, self.rs, capacity, min_tokens=min_tokens, row_tokens=ROW)
        self.pp = BlockPool(PagedKVConfig(block_tokens=BT, pool_blocks=pool_blocks))
        self.ps = BlockStore(_PortModel(), L, PagedKVConfig(block_tokens=BT, pool_blocks=pool_blocks), "float32")
        self.pc = PagedPrefixCache(self.pp, self.ps, capacity, min_tokens=min_tokens)
        self.held = []  # references the test holds, as (ref blocks, port blocks)

    def store(self, ids, seed):
        row = _rows(seed)
        self.rc.store(ids, {n: self.jnp.asarray(a) for n, a in row.items()})
        self.pc.store(ids, {n: torch.from_numpy(a) for n, a in row.items()})

    def commit_table(self, n_tokens, seed):
        """A live page table: fresh blocks holding a committed row."""
        row = _rows(seed)
        nb = -(-n_tokens // BT)
        rb, pb = self.rp.alloc(nb), self.pp.alloc(nb)
        self.rs.commit_row({n: self.jnp.asarray(a) for n, a in row.items()}, list(range(nb)), rb)
        self.ps.commit_row({n: torch.from_numpy(a) for n, a in row.items()}, list(range(nb)), pb)
        self.held.append((rb, pb))
        return rb, pb

    def check(self):
        assert self.pp.used == self.rp.used and self.pp.free == self.rp.free
        for b in range(self.pp.total):
            assert self.pp.refcount(b) == self.rp.refcount(b), b
        self.pp.check_conservation()
        self.rp.check_conservation()


@pytest.fixture
def pair():
    return _Pair()


def test_store_dedups_against_the_parent(pair):
    base = list(range(100, 108))  # 2 full blocks
    pair.store(base, 1)
    pair.check()
    assert pair.pp.used == 2
    pair.store(base + [1, 2, 3, 4, 5], 2)  # the parent's 2 blocks aliased, 2 own
    pair.check()
    assert pair.pp.used == 4 and pair.pp.shared_blocks == 2
    pair.store(base, 3)  # an exact repeat stores nothing
    pair.check()
    pair.store([1, 2, 3], 4)  # below min_tokens
    pair.check()
    pair.rc.clear()
    pair.pc.clear()
    pair.check()
    assert pair.pp.used == 0


def test_hits_alias_full_blocks_and_retain_the_partial_tail(pair):
    prompt = list(range(50, 60))  # 2 full blocks + 2 tokens
    pair.store(prompt, 5)
    pair.check()
    ref = pair.rc.lookup_blocks(prompt + [7, 8, 9])
    got = pair.pc.lookup_blocks(prompt + [7, 8, 9])
    assert got == ref and got[0] == 10 and got[2] == 2
    pair.check()
    n, blocks, _ = got
    want_row = pair.rs.gather_row(ref[1], ROW)
    got_row = pair.ps.gather_row(blocks, ROW)
    for name in ("k", "v"):
        np.testing.assert_array_equal(got_row[name][:, :, :n].numpy(), np.asarray(want_row[name])[:, :, :n])
        assert not got_row[name][:, :, len(blocks) * BT:].any()
    # a miss: no proper prefix, and a prompt equal to the entry (>= 1 token must remain)
    assert pair.pc.lookup_blocks(prompt) is None and pair.rc.lookup_blocks(prompt) is None
    assert pair.pc.lookup_blocks([9] + prompt) is None and pair.rc.lookup_blocks([9] + prompt) is None
    assert pair.pc.stats == pair.rc.stats
    # the adopter's references go back
    pair.rp.free_blocks(ref[1])
    pair.pp.free_blocks(blocks)
    pair.check()


def test_live_table_snapshot_is_zero_copy(pair):
    rb, pb = pair.commit_table(11, 6)
    used = pair.pp.used
    ids = list(range(200, 211))
    assert pair.rc.store_blocks(ids, 11, rb) == pair.pc.store_blocks(ids, 11, pb) is True
    pair.check()
    assert pair.pp.used == used and all(pair.pp.refcount(b) == 2 for b in pb)
    # the same prompt again, or a length that is not the prompt's, stores nothing
    assert pair.pc.store_blocks(ids, 11, pb) is False and pair.rc.store_blocks(ids, 11, rb) is False
    assert pair.pc.store_blocks(ids, 10, pb) is False
    pair.check()
    # the table's owner finishes: the entry keeps the blocks alive
    pair.rp.free_blocks(rb)
    pair.pp.free_blocks(pb)
    pair.check()
    assert pair.pp.used == used
    pair.rc.clear()
    pair.pc.clear()
    pair.check()
    assert pair.pp.used == 0


def test_eviction_releases_blocks():
    pair = _Pair(capacity=2)
    for i, base in enumerate((10, 20, 30)):  # the third store evicts the first (LRU)
        pair.store([base + j for j in range(8)], i)
        pair.check()
    assert pair.pp.used == 4
    # a hit bumps its entry: the next store evicts the other one
    got, want = pair.pc.lookup_blocks(list(range(20, 30))), pair.rc.lookup_blocks(list(range(20, 30)))
    assert got == want
    pair.pp.free_blocks(got[1])
    pair.rp.free_blocks(want[1])
    pair.store(list(range(40, 48)), 7)
    pair.check()
    assert pair.pc.lookup_blocks(list(range(20, 29))) is not None  # kept
    assert pair.pc.lookup_blocks(list(range(30, 39))) is None  # evicted


def test_store_the_pool_cannot_cover_is_skipped():
    pair = _Pair(pool_blocks=4)
    rb, pb = pair.commit_table(12, 1)  # 3 of 4 blocks held by a live table
    pair.store(list(range(60, 70)), 2)  # needs 3 blocks: skipped, no error
    pair.check()
    assert len(pair.pc) == 0 and pair.pp.used == 3
    pair.store(list(range(60, 64)), 3)  # one block fits
    pair.check()
    assert len(pair.pc) == 1 and pair.pp.used == 4


def test_prefix_index_matching_rules():
    """Longest strict proper prefix, at least one token left, LRU eviction
    through on_evict, tiny prompts skipped."""
    evicted = []
    idx = PrefixIndex(capacity=2, min_tokens=3, on_evict=evicted.append)
    assert idx.put([1, 2], "short") is False
    assert idx.put([1, 2, 3], "a") and idx.put([1, 2, 3, 4, 5], "b")
    assert idx.lookup([1, 2, 3, 4, 5, 6]) == (5, "b")
    assert idx.lookup([1, 2, 3, 4, 5]) == (3, "a")  # an equal entry leaves nothing to prefill
    assert idx.lookup([9, 1, 2, 3]) is None
    assert idx.match_quiet([1, 2, 3, 4, 5]) == (5, "b")
    assert idx.put([7, 8, 9], "c")  # evicts the least recently used: "b"
    assert evicted == ["b"] and len(idx) == 2
    assert idx.stats == {"hits": 2, "misses": 1, "stores": 3, "evictions": 1}
    idx.clear()
    assert sorted(evicted) == ["a", "b", "c"]


# ---- the batched engine's prefix path, against the reference's -----------


def _stream(eng, dec, nonce, ids, steps):
    res = eng.prefill_and_sample(nonce, ids, dec)
    toks = [int(res.token[0])]
    for _ in range(steps - 1):
        out, errs = eng.decode_batch({nonce: (toks[-1], dec)})
        assert not errs
        toks.append(int(out[nonce].token[0]))
    return toks


def _cow_run(eng, dec, base, grown):
    """`base` stored, then `grown` (diverging inside base's partial block)
    adopts its blocks; base keeps decoding out of its own, unmutated
    partial block."""
    eng.paged_prefix.min_tokens = 8
    got_base = [_stream(eng, dec, "b", base, 1)[0]]
    got_grown = _stream(eng, dec, "g", grown, 6)
    for _ in range(5):
        out, errs = eng.decode_batch({"b": (got_base[-1], dec)})
        assert not errs
        got_base.append(int(out["b"].token[0]))
    eng.end_session("b")
    eng.end_session("g")
    eng.kv_pool.check_conservation()
    return got_base, got_grown


def test_mid_block_divergence_copies_the_shared_block(tiny_llama_dir, monkeypatch):
    """tests/subsystems/test_ragged_parity.py's copy-on-write case on both
    engines (paged + ragged, 8-token blocks, a prefix cache of 4): a prompt
    diverging inside a shared block copies it, both streams equal the
    reference's, the copy is counted and the pool balances."""
    from dnet_tpu.config import reset_settings_cache
    from dnet_tpu.core.batch import BatchedEngine as RefEngine
    from dnet_tpu.core.types import DecodingParams as RefDec
    from dnet_tpu_torch.core.batch import BatchedEngine
    from dnet_tpu_torch.core.types import DecodingParams

    for k, v in {"DNET_KV_PAGED": "1", "DNET_KV_RAGGED": "1", "DNET_KV_BLOCK_TOKENS": "8",
                 "DNET_FLASH_INTERPRET": "1"}.items():
        monkeypatch.setenv(k, v)
    reset_settings_cache()
    base = list(range(200, 220))  # 20 tokens: 2 full blocks + 4 in a third
    grown = base + [7, 2]
    kw = dict(slots=4, max_seq=64, param_dtype="float32", prefix_cache_size=4)
    ref = RefEngine(tiny_llama_dir, **kw)
    try:
        want = _cow_run(ref, RefDec(temperature=0.0), base, grown)
    finally:
        ref.close()
        reset_settings_cache()
    eng = BatchedEngine(tiny_llama_dir, device="cpu", **kw)
    got = _cow_run(eng, DecodingParams(temperature=0.0), base, grown)
    assert got == want
    stats = eng.stats()["prefix_cache"]
    assert stats["hits"] == 1 and stats["cow_copies"] == 1 and stats["shared_blocks"] >= 2
    eng.paged_prefix.clear()
    assert eng.kv_pool.used == 0
