"""The port's paged KV pool (kv/paged.py) and pool tensors (kv/store.py).

The allocator is held against dnet_tpu's: the same sequence of operations
gives the same block ids, free counts and books.  The store's two writes
are checked on their own: a committed row reads back through its blocks,
an append lands at (block, offset), and a lane not listed writes nothing.
"""

import pytest
import torch

from dnet_tpu.config import reset_settings_cache
from dnet_tpu.kv.paged import BlockPool as RefPool
from dnet_tpu.kv.paged import KVPoolExhausted as RefExhausted
from dnet_tpu.kv.paged import PagedKVConfig as RefConfig
from dnet_tpu.kv.paged import PageTable as RefTable
from dnet_tpu_torch.config import batch_slots_default, kv_settings, sched_enabled
from dnet_tpu_torch.kv import (
    BlockPool,
    BlockStore,
    KVPoolExhausted,
    PagedKVConfig,
    PageTable,
    paged_enabled,
    ragged_enabled,
)
from dnet_tpu_torch.models import ModelConfig, get_ring_model_cls

pytestmark = pytest.mark.core


@pytest.fixture
def kv_env(monkeypatch):
    def set_env(**values):
        for k, v in values.items():
            monkeypatch.setenv(k, str(v))
        reset_settings_cache()

    yield set_env
    reset_settings_cache()


def _script(pool, table_cls, exhausted):
    """One fixed sequence of pool operations; returns everything observable."""
    seen = []
    a, b, c = table_cls(), table_cls(), table_cls()
    seen.append(("ensure", pool.ensure(a, 20), pool.free, pool.used))  # 3 blocks at bt 8
    seen.append(("ensure", pool.ensure(b, 8), pool.free))
    seen.append(("noop", pool.ensure(a, 24), pool.free))  # already covered
    seen.append(("grow", pool.ensure(a, 25), pool.free))
    shared = pool.share(a.blocks[:2])
    c.blocks.extend(shared)
    seen.append(("share", [pool.refcount(x) for x in a.blocks], pool.used))
    c.blocks[1] = pool.cow(c.blocks[1])  # c diverges inside its second block
    seen.append(("cow", c.blocks[1], pool.refcount(a.blocks[1])))
    try:
        pool.alloc(pool.free + 1)
        seen.append("alloc did not raise")
    except exhausted as exc:
        seen.append(("exhausted", str(exc), exc.need, exc.free, exc.total, pool.free))
    try:
        pool.require(pool.free + 2)
    except exhausted as exc:
        seen.append(("require", str(exc)))
    seen.append(("release", pool.release_table(b), pool.free, b.blocks))
    seen.append(("free", pool.free_blocks(c.blocks[:1]), pool.refcount(a.blocks[0])))
    del c.blocks[0]
    pool.check_conservation([a.blocks, c.blocks])
    seen.append(("release", pool.release_table(a), pool.release_table(c), pool.free, pool.used))
    seen.append(("peak", pool.peak_used))
    pool.check_conservation([])
    seen.append(("realloc", pool.alloc(3), pool.free))
    return seen


def test_pool_operations_match_the_reference(kv_env):
    kv_env(DNET_KV_BLOCK_TOKENS=8)
    ref = _script(RefPool(RefConfig.from_settings(64, slots=2)), RefTable, RefExhausted)
    got = _script(BlockPool(PagedKVConfig.from_settings(64, slots=2)), PageTable, KVPoolExhausted)
    assert got == ref
    assert got[6][1].startswith("paged KV pool exhausted")


def test_config_from_settings_matches_the_reference(kv_env):
    for env in ({}, {"DNET_KV_BLOCK_TOKENS": 8}, {"DNET_KV_POOL_BLOCKS": 5, "DNET_KV_BLOCK_TOKENS": 32}):
        kv_env(**env)
        for max_seq, slots in ((64, 1), (4096, 8)):
            assert PagedKVConfig.from_settings(max_seq, slots).__dict__ == \
                RefConfig.from_settings(max_seq, slots).__dict__
    kv_env(DNET_KV_BLOCK_TOKENS=24)
    with pytest.raises(ValueError, match="must be >= 1 and divide max_seq=64"):
        PagedKVConfig.from_settings(64)
    with pytest.raises(ValueError):
        PagedKVConfig(block_tokens=8, pool_blocks=0)


def test_alloc_is_all_or_nothing():
    pool = BlockPool(PagedKVConfig(block_tokens=4, pool_blocks=3))
    t = PageTable()
    pool.ensure(t, 8)
    with pytest.raises(KVPoolExhausted, match=r"need 2 block\(s\), 1 free of 3"):
        pool.ensure(t, 16)
    assert len(t.blocks) == 2 and pool.free == 1 and pool.admission_rejected == 1
    pool.check_conservation([t.blocks])
    with pytest.raises(ValueError, match="unallocated"):
        pool.free_blocks([t.blocks[0], 99])


def test_settings_switches(monkeypatch):
    for k in ("DNET_KV_PAGED", "DNET_KV_RAGGED", "DNET_SCHED", "DNET_API_BATCH_SLOTS"):
        monkeypatch.delenv(k, raising=False)
    assert not paged_enabled() and not ragged_enabled() and not sched_enabled()
    assert batch_slots_default() == 1 and batch_slots_default(3) == 3
    monkeypatch.setenv("DNET_KV_PAGED", "1")
    monkeypatch.setenv("DNET_KV_RAGGED", "true")
    monkeypatch.setenv("DNET_SCHED", "on")
    monkeypatch.setenv("DNET_API_BATCH_SLOTS", "6")
    assert paged_enabled() and ragged_enabled() and sched_enabled()
    assert batch_slots_default() == 6 and batch_slots_default(2) == 2
    assert kv_settings().block_tokens == 16
    monkeypatch.setenv("DNET_KV_PAGED", "maybe")
    with pytest.raises(ValueError, match="DNET_KV_PAGED"):
        paged_enabled()


def _store(bt=4, blocks=6):
    cfg = ModelConfig.from_hf({
        "model_type": "llama", "vocab_size": 17, "hidden_size": 8, "intermediate_size": 16,
        "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 1,
        "head_dim": 4,
    })
    model = get_ring_model_cls(cfg.model_type)(cfg, range(2), torch.device("cpu"))
    return BlockStore(model, 2, PagedKVConfig(block_tokens=bt, pool_blocks=blocks), "float32")


def test_store_commit_row_round_trips():
    store = _store()
    assert store.kv["k"].shape == (2, 6, 4, 1, 4)
    g = torch.Generator().manual_seed(0)
    row = {n: torch.randn(2, 1, 12, 1, 4, generator=g) for n in ("k", "v")}
    store.commit_row(row, [0, 1, 2], [5, 0, 3])
    for n in ("k", "v"):
        back = store.kv[n][:, [5, 0, 3]].reshape(2, 12, 1, 4)
        torch.testing.assert_close(back, row[n][:, 0], rtol=0, atol=0)
        assert not store.kv[n][:, [1, 2, 4]].any()
    with pytest.raises(ValueError, match="outside"):
        store.commit_row(row, [0], [6])


def test_store_append_writes_active_lanes_only():
    store = _store()
    before = {n: t.clone() for n, t in store.kv.items()}
    g = torch.Generator().manual_seed(1)
    rows = {n: torch.randn(2, 4, 1, 4, generator=g) for n in ("k", "v")}  # [L, slots, KVH, Hd]
    store.append_rows(rows, lanes=[1, 3], phys=[2, 4], off=[3, 0])
    for n in ("k", "v"):
        torch.testing.assert_close(store.kv[n][:, 2, 3], rows[n][:, 1], rtol=0, atol=0)
        torch.testing.assert_close(store.kv[n][:, 4, 0], rows[n][:, 3], rtol=0, atol=0)
        changed = (store.kv[n] != before[n]).any(dim=(0, 3, 4))  # [blocks, bt]
        assert changed.nonzero().tolist() == [[2, 3], [4, 0]]
    # the reference's "drop" sentinels (block == pool size, negative) are
    # refused instead of wrapping onto a live block
    for phys, off in (([6], [0]), ([-1], [0]), ([0], [4])):
        with pytest.raises(ValueError, match="outside"):
            store.append_rows(rows, [0], phys, off)
    store.append_rows(rows, [], [], [])
    with pytest.raises(ValueError, match="lengths differ"):
        store.append_rows(rows, [0, 1], [0], [0])
