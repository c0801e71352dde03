"""The snapshot prefix cache in the port against dnet_tpu's (mirroring
tests/test_prefix_cache.py, but for its mesh and pipelined-engine cases).

A hit restores a stored prompt's KV and prefills only the rest: its
last-position logits are within 2e-3 (the repo's parity tolerance) of the
reference's cold prefill and of the reference's own hit, on the
single-sequence engine, over its paged ledger (PagedPrefixCache's dense
facade) and on dense batched slots (the inner engine's snapshots, through
the chunked prefill's full-prompt lookup and store).  Snapshots are
clones both ways, so an entry survives its borrower's steps."""

import asyncio

import numpy as np
import pytest
import torch

from dnet_tpu_torch.core.prefix_cache import PrefixCache
from dnet_tpu_torch.core.types import DecodingParams

pytestmark = pytest.mark.core

TOL = dict(atol=2e-3, rtol=2e-3)
SYSTEM = [256, 83, 89, 83, 84, 69, 77]  # a shared "system prompt"
GREEDY = DecodingParams(temperature=0.0)


def _port(d, max_seq=64, **kw):
    from dnet_tpu_torch.core.engine import LocalEngine

    eng = LocalEngine(d, max_seq=max_seq, param_dtype="float32", device="cpu", **kw)
    if eng.prefix_cache is not None:
        eng.prefix_cache.min_tokens = 1  # tiny test prompts
    return eng


def _ref(d, max_seq=64, **kw):
    from dnet_tpu.core.engine import LocalEngine

    eng = LocalEngine(d, max_seq=max_seq, param_dtype="float32", **kw)
    if eng.prefix_cache is not None:
        eng.prefix_cache.min_tokens = 1
    return eng


def test_lookup_semantics():
    """A proper prefix hits (a copy), the exact prompt does not (one token
    must be left to prefill), a diverging prompt misses, the oldest entry is
    evicted at capacity."""
    pc = PrefixCache(capacity=2, min_tokens=1)
    kv = {"k": torch.zeros(2, 2)}
    pc.store([1, 2, 3], kv)
    assert pc.lookup([1, 2, 3]) is None
    n, got = pc.lookup([1, 2, 3, 4])
    assert n == 3 and got["k"].shape == (2, 2) and got["k"] is not kv["k"]
    got["k"].add_(1)
    assert pc.lookup([1, 2, 3, 5])[1]["k"].sum() == 0  # the entry is a copy too
    assert pc.lookup([1, 9, 3, 4]) is None
    pc.store([5, 6], kv)
    pc.store([7, 8], kv)
    assert pc.lookup([1, 2, 3, 4]) is None
    assert pc.lookup([5, 6, 0]) is not None
    assert pc.stats == {"hits": 3, "misses": 3, "stores": 3}


def test_tiny_prompts_not_stored():
    pc = PrefixCache(capacity=2, min_tokens=16)
    pc.store(list(range(8)), {"k": torch.zeros(1)})
    assert pc.stats["stores"] == 0 and len(pc) == 0


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_hit_matches_reference(tiny_llama_dir, monkeypatch, paged):
    """q1 and q2 share only SYSTEM (a miss each, both stored); q3 extends q2
    (a hit).  The port's logits equal the reference's cold prefill and the
    reference's own hit; the decode after a hit continues as the cold
    stream.  Paged: the single-sequence engine's ledger with the block
    cache's dense facade."""
    from dnet_tpu.config import reset_settings_cache
    from dnet_tpu.core.types import DecodingParams as RefDecoding

    if paged:
        monkeypatch.setenv("DNET_KV_PAGED", "1")
        monkeypatch.setenv("DNET_KV_BLOCK_TOKENS", "8")
    reset_settings_cache()
    q1, q2 = SYSTEM + [72, 105], SYSTEM + [66, 121, 101]
    q3 = q2 + [33]
    cold, ref_warm = _ref(tiny_llama_dir), _ref(tiny_llama_dir, prefix_cache_size=2)
    warm = _port(tiny_llama_dir, prefix_cache_size=2)
    assert (warm.kv_pool is not None) == paged
    assert type(warm.prefix_cache).__name__ == ("PagedPrefixCache" if paged else "PrefixCache")
    for i, q in enumerate((q1, q2, q3)):
        got = warm.prefill(f"p{i}", q).numpy()
        want = np.asarray(cold.prefill(f"p{i}", q), np.float32)
        hit = np.asarray(ref_warm.prefill(f"p{i}", q), np.float32)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, hit, **TOL)
        for e in (warm, cold, ref_warm):
            e.end_session(f"p{i}")
    assert warm.prefix_cache.stats == {"hits": 1, "misses": 2, "stores": 3} == ref_warm.prefix_cache.stats
    toks = [r.token_id for r in warm.generate(q3, GREEDY, max_tokens=6, nonce="d")]
    assert toks == [r.token_id for r in cold.generate(q3, RefDecoding(temperature=0.0), max_tokens=6, nonce="d")]
    assert warm.stats()["prefix_cache"]["hits"] == 2
    if paged:
        assert warm.kv_pool.used == warm.prefix_cache.held_blocks()  # no session holds blocks now
    monkeypatch.undo()
    reset_settings_cache()


def test_snapshot_survives_the_next_step(tiny_llama_dir):
    """The entry a session was restored from is unchanged by that session's
    decode: a second identical request gets the identical stream."""
    eng = _port(tiny_llama_dir, prefix_cache_size=2)
    base = [256, 72, 101, 108]
    list(eng.generate(base + [108], GREEDY, max_tokens=3, nonce="a"))
    out1 = [r.token_id for r in eng.generate(base + [108, 111], GREEDY, max_tokens=3, nonce="b")]
    out2 = [r.token_id for r in eng.generate(base + [108, 111], GREEDY, max_tokens=3, nonce="c")]
    assert out1 == out2
    assert eng.prefix_cache.stats["hits"] >= 2


def test_too_long_prompt_leaves_no_session(tiny_llama_dir):
    """A hit-eligible but over-length prompt fails before the lookup and
    leaves no session behind."""
    eng = _port(tiny_llama_dir, max_seq=32, prefix_cache_size=2)
    base = list(range(1, 21))
    eng.prefill("a", base)
    eng.end_session("a")
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.prefill("b", base + list(range(21, 41)))
    assert "b" not in eng.sessions
    assert eng.prefix_cache.stats["hits"] == 0


def test_streamed_weights_disable_the_prefix_cache(tiny_llama_dir):
    """The reference's rule: a weight-streaming engine warns and keeps no
    prefix cache."""
    eng = _port(tiny_llama_dir, prefix_cache_size=2, window_size=2, residency_size=1)
    assert eng.plan.streams_weights and eng.prefix_cache is None
    eng.close()


def test_batched_dense_slots_hit(tiny_llama_dir):
    """Dense batched slots: the chunk API's full-prompt lookup (as the
    batched adapter drives it) seeds from the snapshot and prefills only the
    suffix; the first token equals a full prefill's and the reference's."""
    from dnet_tpu.core.batch import BatchedEngine as RefBatched
    from dnet_tpu.core.types import DecodingParams as RefDecoding
    from dnet_tpu_torch.core.batch import BatchedEngine

    eng = BatchedEngine(tiny_llama_dir, slots=2, max_seq=128, param_dtype="float32", device="cpu",
                        prefix_cache_size=2)
    assert eng.kv_pool is None and eng.eng.prefix_cache is not None
    prompt = [256] + list(range(40, 80))  # 41 tokens: at least min_tokens
    assert eng.seed_from_prefix("r1", prompt, None) == 0
    logits = eng.prefill_chunk("r1", prompt)
    eng.store_prefix("r1", prompt)
    eng.adopt_prefilled("r1", logits, GREEDY)
    eng.end_session("r1")
    prompt2 = prompt + [99, 98, 97]
    n = eng.seed_from_prefix("r2", prompt2, None)
    assert n == len(prompt)
    r2 = eng.adopt_prefilled("r2", eng.prefill_chunk("r2", prompt2[n:]), GREEDY)
    assert eng.stats()["prefix_cache"]["hits"] == 1
    full = eng.prefill_and_sample("r3", prompt2, GREEDY)
    ref = RefBatched(tiny_llama_dir, slots=2, max_seq=128, param_dtype="float32", kv_paged=False)
    want = ref.prefill_and_sample("w", prompt2, RefDecoding(temperature=0.0))
    assert int(r2.token[0]) == int(full.token[0]) == int(want.token[0])


def test_chunked_prefill_hits_and_interleaves(tiny_llama_dir):
    """Through the batched adapter: a long prompt prefills chunk by chunk
    while an active lane's decode steps run between the chunks, and a second
    request that extends it prefills only its new tokens (one hit)."""
    from dnet_tpu_torch.api.strategies import BatchedLocalAdapter
    from dnet_tpu_torch.core.batch import BatchedEngine

    eng = BatchedEngine(tiny_llama_dir, slots=2, max_seq=1024, param_dtype="float32", device="cpu",
                        prefix_cache_size=2)
    events = []
    chunk, decode = eng.prefill_chunk, eng.decode_batch

    def chunk_spy(nonce, ids, seed=None):
        events.append(("chunk", nonce, len(ids)))
        return chunk(nonce, ids, seed)

    def decode_spy(reqs, budgets=None):
        events.append(("decode",))
        return decode(reqs, budgets)

    eng.prefill_chunk, eng.decode_batch = chunk_spy, decode_spy
    long_ids = [256] + [i % 250 + 1 for i in range(379)]  # in the tiny vocabulary

    async def go():
        adapter = BatchedLocalAdapter(eng)
        adapter.PREFILL_CHUNK = 64
        await adapter.start()
        try:
            await adapter.send_tokens("fast", [256, 72], GREEDY, 0)
            tok = (await adapter.await_token("fast", 0, 60.0)).token_id
            await adapter.send_tokens("slow", long_ids, GREEDY, 0)
            for step in range(1, 6):
                await adapter.send_tokens("fast", [tok], GREEDY, step)
                r = await adapter.await_token("fast", step, 60.0)
                assert not r.error
                tok = r.token_id
            r = await adapter.await_token("slow", 0, 60.0)
            assert not r.error
            await adapter.reset_cache("slow")
            await adapter.send_tokens("again", long_ids + [7, 8], GREEDY, 0)
            r = await adapter.await_token("again", 0, 60.0)
            assert not r.error
        finally:
            await adapter.shutdown()

    asyncio.run(go())
    kinds = [e[0] for e in events]
    first = kinds.index("chunk")
    last = max(i for i, e in enumerate(events) if e[:2] == ("chunk", "slow"))
    assert "decode" in kinds[first:last], events
    assert [e[2] for e in events if e[:2] == ("chunk", "again")] == [2]
    assert eng.stats()["prefix_cache"]["hits"] == 1
