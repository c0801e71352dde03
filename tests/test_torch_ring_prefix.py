"""The ring prefix cache on port shards, against the reference's.

The API alone sees token ids, so it matches prompts and keys every
snapshot through the step-0 frames; each shard keeps its own window's KV
under that key (shard/compute.py, core/prefix_cache.py `SnapshotStore`).
The counterpart of tests/test_ring_prefix.py's cases without a mesh: a hit
prefills only the suffix and gives the full prefill's stream (on a port
chain, a reference chain, and through both rings); a shard without the
snapshot fails with a parseable `prefix-miss:` error; a snapshot is a copy
the storing request's decode does not touch; the API's index gives the
reference's keys; a miss after the shards lost their snapshots refills
the whole prompt transparently (dnet_prefix_refill_total + 1); and the
race the reference's refill answers (a request that extends a prompt
whose prefill is still in flight hits a key no shard holds yet) refills
and matches a cold run, on both packages.
"""

import asyncio
import importlib

import numpy as np
import pytest

from dnet_tpu_torch.core.types import DecodingParams
from tests.torch_ring_harness import MAX_SEQ, _local_streams, _run_ring, _serve

pytestmark = [pytest.mark.ring, pytest.mark.shard]

PROMPT = [256, 72, 101, 108, 108, 111, 7, 3, 11, 7, 3, 11, 256, 84, 104, 101]
N = 4
GREEDY = DecodingParams(temperature=0.0)
PKGS = ("dnet_tpu_torch", "dnet_tpu")


def _chain(pkg, model_dir, prefix_cache):
    compute = importlib.import_module(f"{pkg}.shard.compute")
    kw = dict(max_seq=MAX_SEQ, param_dtype="float32", wire_dtype="float32", prefix_cache=prefix_cache)
    if pkg == "dnet_tpu_torch":
        kw["device"] = "cpu"
    return [compute.ShardCompute(model_dir, ls, **kw) for ls in ([0, 1], [2, 3])]


def _drive(pkg, shards, nonce, ids, n, pos0=0, store="", hit=""):
    """A prompt frame (a suffix after a cached prefix with `hit`) through the
    chain, then greedy decode a token at a time."""
    message = importlib.import_module(f"{pkg}.core.types").ActivationMessage
    dec = importlib.import_module(f"{pkg}.core.types").DecodingParams(temperature=0.0)
    toks, arr, pos = [], np.asarray([ids], dtype=np.int32), pos0
    for step in range(n):
        msg = message(nonce=nonce, layer_id=-1, seq=step, dtype="tokens", shape=arr.shape, data=arr.tobytes(),
                      pos=pos, decoding=dec, prefix_store=store if step == 0 else "",
                      prefix_hit=hit if step == 0 else "")
        for sc in shards:
            msg = sc.process(msg)
        assert msg.is_final and not msg.error
        pos += arr.shape[1]
        toks.append(msg.token_id)
        arr = np.asarray([[msg.token_id]], dtype=np.int32)
    return toks


@pytest.mark.parametrize("pkg", PKGS)
def test_prefix_hit_matches_full_prefill(tiny_llama_dir, pkg):
    """Store on request 1, hit on request 2 (the grown prompt): the suffix
    prefill gives a fresh chain's full-prefill stream, the same on both
    packages, and every shard counts one store and one hit."""
    shards = _chain(pkg, tiny_llama_dir, 4)
    first = _drive(pkg, shards, "r1", PROMPT, N, store="k1")
    suffix = [first[-1], 256, 110]
    want = _drive(pkg, _chain(pkg, tiny_llama_dir, 0), "ref", PROMPT + suffix, N)
    got = _drive(pkg, shards, "r2", suffix, N, pos0=len(PROMPT), hit="k1")
    assert got == want
    assert [sc.prefix_snaps.stats for sc in shards] == [{"hits": 1, "misses": 0, "stores": 1}] * 2
    if pkg == "dnet_tpu_torch":
        ref = _chain("dnet_tpu", tiny_llama_dir, 4)
        _drive("dnet_tpu", ref, "r1", PROMPT, N, store="k1")
        assert _drive("dnet_tpu", ref, "r2", suffix, N, pos0=len(PROMPT), hit="k1") == got
        assert [sc.health()["prefix_cache"]["entries"] for sc in shards] == [1, 1]


@pytest.mark.parametrize("pkg", PKGS)
def test_prefix_miss_fails_with_parseable_error(tiny_llama_dir, pkg):
    """A key no shard stored, and a disabled cache: the same `prefix-miss:`
    texts from both packages."""
    texts = []
    for cap in (4, 0):
        with pytest.raises(ValueError, match=r"^prefix-miss:ghost: ") as exc:
            _drive(pkg, _chain(pkg, tiny_llama_dir, cap), "r", [1, 2, 3], 1, pos0=8, hit="ghost")
        texts.append(str(exc.value))
    assert texts == ["prefix-miss:ghost: no snapshot on this shard",
                     "prefix-miss:ghost: prefix caching disabled on this shard (streaming, k-round, or capacity 0)"]


def test_prefix_snapshot_isolated_from_decode(tiny_llama_dir):
    """The stored snapshot is a copy: request 1 decodes 8 more tokens into
    its cache after the store, and a later hit still gives the full
    prefill's stream."""
    shards = _chain("dnet_tpu_torch", tiny_llama_dir, 4)
    first = _drive("dnet_tpu_torch", shards, "r1", PROMPT, 8, store="k")
    suffix = [first[0]]
    want = _drive("dnet_tpu_torch", _chain("dnet_tpu_torch", tiny_llama_dir, 0), "ref", PROMPT + suffix, 3)
    assert _drive("dnet_tpu_torch", shards, "r2", suffix, 3, pos0=len(PROMPT), hit="k") == want


def test_adapter_prefix_index_matches_the_references(tiny_llama_dir):
    """The API's index: the reference's keys for the same prompts, the
    longest strict prefix hit, no hit for an equal prompt, LRU eviction at
    capacity, and a prefix-miss error clears the index."""
    from dnet_tpu.api.ring import RingApiAdapter as RefApi
    from dnet_tpu_torch.api.ring import RingApiAdapter
    from dnet_tpu_torch.core.types import TokenResult

    a = RingApiAdapter(head_addr="s0", callback_url="grpc://api:1", prefix_cache=2)
    r = RefApi(head_addr="s0", callback_url="grpc://api:1", ring_client_factory=lambda addr: None, prefix_cache=2)
    ids1 = tuple(range(20))
    key1 = a._prefix_put(ids1)
    assert key1 == r._prefix_put(ids1) and a._prefix_put(ids1) == key1
    grown = ids1 + (99, 98)
    assert a._prefix_lookup(grown) == r._prefix_lookup(grown) == (20, key1)
    assert a._prefix_lookup(ids1) is None
    for ids in (tuple(range(100, 120)), tuple(range(200, 220))):
        assert a._prefix_put(ids) == r._prefix_put(ids)
    assert a._prefix_lookup(grown) is None  # ids1 evicted
    assert a._prefix_lookup(tuple(range(100, 121)))[1] == r._prefix_lookup(tuple(range(100, 121)))[1]
    a.resolve_token(TokenResult(nonce="x", token_id=-1, step=0, error="prefix-miss:zz: gone"))
    assert len(a._prefix_index) == 0


def _refills(pkg):
    return importlib.import_module(f"{pkg}.obs").metric("dnet_prefix_refill_total").value


def test_refill_after_the_shards_lost_their_snapshots(tiny_llama_dir):
    """Turn 2 hits turn 1's snapshot on both shards and answers the cold
    text; after a full reset of the shards (every snapshot gone) the same
    turn misses, refills the whole prompt (dnet_prefix_refill_total + 1)
    and answers the same text."""
    turn2 = PROMPT + [5, 256, 110]
    cold = _local_streams(tiny_llama_dir, prompts=[turn2], steps=N)[0]

    async def drive(api, net, rts):
        await _serve(api, "t1", PROMPT, N, GREEDY)
        hit = await _serve(api, "t2", turn2, N, GREEDY)
        stats = [rt.compute.health()["prefix_cache"]["hits"] for rt in rts]
        for rt in rts:
            rt.compute.reset("")
        before = _refills("dnet_tpu_torch")
        refilled = await _serve(api, "t3", turn2, N, GREEDY)
        return [hit, refilled, stats, _refills("dnet_tpu_torch") - before]

    (hit, refilled, stats, refills), _, _ = asyncio.run(_run_ring(
        tiny_llama_dir, prefix_cache=4, shard_opts=({"prefix_cache": 4}, {"prefix_cache": 4}), drive=drive))
    assert hit == refilled == cold
    assert stats == [1, 1]
    assert refills == 1


def test_refill_unit_mirrors_the_reference():
    """The reference's unit case on the port's adapter: the hit frame
    carries only the suffix; its prefix-miss resets the nonce on both
    shards and re-sends the whole prompt with a store key; a second miss
    on a request fails."""
    from dnet_tpu_torch.api.ring import RingApiAdapter
    from dnet_tpu_torch.core.types import TokenResult
    from tests.fakes.transport import FakeRingClient

    async def go():
        frames, clients = [], {}

        def factory(addr):
            clients[addr] = FakeRingClient(addr, on_frame=frames.append)
            return clients[addr]

        api = RingApiAdapter(head_addr="s0:1", callback_url="grpc://api:1", shard_grpc_addrs=["s0:1", "s1:1"],
                             ring_client_factory=factory, max_seq_len=128, prefix_cache=4)
        await api.start()
        prompt = list(range(100, 120))
        await api.send_tokens("r1", prompt, GREEDY, 0)
        assert frames[-1].prefix_store and not frames[-1].prefix_hit
        api.resolve_token(TokenResult(nonce="r1", token_id=5, step=0))
        await api.await_token("r1", 0, timeout=5.0)
        grown = prompt + [5, 7]
        await api.send_tokens("r2", grown, GREEDY, 0)
        hit = frames[-1]
        assert hit.prefix_hit and hit.pos == len(prompt) and hit.shape[1] == 2
        before = _refills("dnet_tpu_torch")
        api.resolve_token(TokenResult(nonce="r2", token_id=-1, step=0, error=f"prefix-miss:{hit.prefix_hit}: x"))
        for _ in range(200):
            await asyncio.sleep(0.005)
            if frames[-1] is not hit:
                break
        refill = frames[-1]
        assert (refill.nonce, refill.seq, refill.pos, refill.prefix_hit) == ("r2", 0, 0, "")
        assert refill.shape[1] == len(grown) and refill.prefix_store
        assert _refills("dnet_tpu_torch") == before + 1
        assert "r2" in clients["s0:1"].resets and "r2" in clients["s1:1"].resets
        api.resolve_token(TokenResult(nonce="r2", token_id=9, step=0))
        assert (await api.await_token("r2", 0, timeout=5.0)).token_id == 9
        await api.send_tokens("r3", grown + [9, 4], GREEDY, 0)
        api.resolve_token(TokenResult(nonce="r3", token_id=-1, step=0, error="prefix-miss:zz: gone"))
        await asyncio.sleep(0.05)
        api.resolve_token(TokenResult(nonce="r3", token_id=-1, step=0, error="prefix-miss:zz: still gone"))
        assert (await api.await_token("r3", 0, timeout=5.0)).error.startswith("prefix-miss:")
        await api.shutdown()

    asyncio.run(go())


@pytest.mark.parametrize("pkg", PKGS)
def test_prompt_extending_one_in_flight_refills(tiny_llama_dir, pkg):
    """The race the refill answers: the API indexes request A's key when it
    sends A's prompt, so request B, which extends A's prompt, hits that key
    while A's frame has not reached the head; the head holds no snapshot
    yet, B misses and refills, and both answer their cold runs' text."""
    prompt_b = PROMPT + [5, 7]
    cold = _local_streams(tiny_llama_dir, prompts=[PROMPT, prompt_b], steps=N)
    kind = "port" if pkg == "dnet_tpu_torch" else "ref"

    async def drive(api, net, rts):
        gate = net.hold[("s0", "A", 0)] = asyncio.Event()
        task_a = asyncio.ensure_future(_serve(api, "A", PROMPT, N, GREEDY))
        for _ in range(100):  # A's key indexed, its frame held before the head
            await asyncio.sleep(0.005)
            if api._prefix_index.get_exact(PROMPT) is not None:
                break
        before = _refills(pkg)
        b = await _serve(api, "B", prompt_b, N, GREEDY)
        refills = _refills(pkg) - before
        gate.set()
        return [await task_a, b, refills]

    (a, b, refills), _, _ = asyncio.run(_run_ring(
        tiny_llama_dir, kinds=(kind, kind), api_kind=kind, prefix_cache=4,
        shard_opts=({"prefix_cache": 4}, {"prefix_cache": 4}), drive=drive))
    assert [a, b] == cold
    assert refills == 1
