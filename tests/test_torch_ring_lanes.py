"""Batched ring lanes (DNET_API_RING_LANES) on the port, held to solo
streams and to the reference's lanes ring.

- The reference's shard-lane cases (tests/test_shard_lanes.py) rebound onto
  the port's ShardCompute on the CPU: coalesced multi-lane decode frames
  through a two-shard chain give every member exactly its solo stream, in
  f32, greedy and seeded, for llama, gpt_oss (paired ranges: the rotating
  lane form) and deepseek_v2 (the (192, 128) MLA lane form), with one
  decode call a layer a frame over every lane; partial batches and
  leavers, a one-shard ring, and faulted, unknown and all-faulted members
  failing alone.
- Concurrent greedy chats through both packages' whole API stacks over
  in-process two-shard rings with DNET_API_RING_LANES=4: the port's SSE
  byte-identical to the reference's, to its own serial streams, and
  served in multi-lane frames.
"""

import asyncio
import re
from dataclasses import asdict

import numpy as np
import pytest

import dnet_tpu_torch.ops.attention as port_attention
from dnet_tpu.config import reset_settings_cache
from dnet_tpu_torch.core.types import ActivationMessage, DecodingParams
from tests.torch_ring_harness import MAX_SEQ, SPLIT, HttpRing

pytestmark = [pytest.mark.ring, pytest.mark.shard]

N_TOK = 6
PROMPTS = {"a": [256, 72, 101], "b": [256, 84, 104, 101], "c": [7, 3, 11, 7, 3], "d": [256, 110]}


@pytest.fixture(scope="module")
def family_dirs(tiny_llama_dir, tmp_path_factory):
    from tests.fakes.checkpoints import make_tiny_deepseek_v2, make_tiny_gpt_oss

    dirs = {"llama": tiny_llama_dir}
    for name, make, kw in (("gpt_oss", make_tiny_gpt_oss, {}), ("deepseek_v2", make_tiny_deepseek_v2, {"seed": 5})):
        d = tmp_path_factory.mktemp(name)
        make(d, **kw)
        dirs[name] = d
    return dirs


def _shards(model_dir, lanes, split=SPLIT):
    from dnet_tpu_torch.shard.compute import ShardCompute

    return [ShardCompute(model_dir, ls, max_seq=MAX_SEQ, param_dtype="float32", wire_dtype="float32", lanes=lanes,
                         device="cpu") for ls in split]


def _prefill(shards, nonce, ids, dec):
    arr = np.asarray([ids], dtype=np.int32)
    msg = ActivationMessage(nonce=nonce, layer_id=-1, seq=0, dtype="tokens", shape=arr.shape, data=arr.tobytes(),
                            pos=0, decoding=dec)
    for sc in shards:
        msg = sc.process(msg)
    assert msg.is_final and not msg.error, msg.error
    return msg.token_id


def _solo_stream(model_dir, ids, dec, n, split=SPLIT):
    """One request through a lane-free chain."""
    shards = _shards(model_dir, 0, split)
    toks, pos = [_prefill(shards, "solo", ids, dec)], len(ids)
    for step in range(1, n):
        arr = np.asarray([[toks[-1]]], dtype=np.int32)
        msg = ActivationMessage(nonce="solo", layer_id=-1, seq=step, dtype="tokens", shape=arr.shape,
                                data=arr.tobytes(), pos=pos, decoding=dec)
        for sc in shards:
            msg = sc.process(msg)
        toks.append(msg.token_id)
        pos += 1
    return toks


def _batch_frame(members, seq):
    """members: (nonce, token, pos, decoding) each."""
    tokens = np.asarray([[t] for _, t, _, _ in members], dtype=np.int32)
    return ActivationMessage(nonce="__lanes__", layer_id=-1, seq=seq, dtype="tokens", shape=tokens.shape,
                             data=tokens.tobytes(), pos=0,
                             lanes=[{"nonce": n, "seq": seq, "pos": p, "decoding": asdict(d)} for n, _, p, d in members])


def _step(shards, members, seq) -> dict:
    msg = _batch_frame(members, seq)
    for sc in shards:
        msg = sc.process(msg)
    assert msg.is_final and msg.lane_finals is not None
    return {f["nonce"]: f for f in msg.lane_finals}


@pytest.fixture
def decode_calls(monkeypatch):
    """(batch, rotating, k head dim != v head dim) of each decode call the
    lane hook makes."""
    calls, real = [], port_attention.flash_decode_attend

    def spy(q, k, v, lengths, max_live, **kw):
        calls.append((q.shape[0], bool(kw.get("rotating")), k.shape[-1] != v.shape[-1]))
        return real(q, k, v, lengths, max_live, **kw)

    monkeypatch.setattr(port_attention, "flash_decode_attend", spy)
    return calls


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "seeded"])
@pytest.mark.parametrize("family", ["llama", "gpt_oss", "deepseek_v2"])
def test_lane_streams_match_solo(family_dirs, family, greedy, decode_calls):
    """4 concurrent members, mixed prompts (and seeds when sampling), decoded
    through coalesced batch frames == each member's solo stream; each frame
    makes one decode call a layer on each shard over all 4 lanes, through
    the rotating form on gpt_oss's sliding layers and the MLA form on
    deepseek_v2's."""
    d = family_dirs[family]
    decs = {n: DecodingParams(temperature=0.0) if greedy else DecodingParams(temperature=0.8, top_p=0.9, seed=41 + i)
            for i, n in enumerate(PROMPTS)}
    want = {n: _solo_stream(d, PROMPTS[n], decs[n], N_TOK) for n in PROMPTS}
    shards = _shards(d, 4)
    got = {n: [_prefill(shards, n, PROMPTS[n], decs[n])] for n in PROMPTS}
    pos = {n: len(PROMPTS[n]) for n in PROMPTS}
    decode_calls.clear()
    for step in range(1, N_TOK):
        finals = _step(shards, [(n, got[n][-1], pos[n], decs[n]) for n in PROMPTS], step)
        for n in PROMPTS:
            got[n].append(int(finals[n]["token_id"]))
            pos[n] += 1
    assert got == want
    assert all(len(sc.lane_pool.slot_of) == 4 for sc in shards)
    layers = sum(len(sc.layers) for sc in shards)
    assert len(decode_calls) == layers * (N_TOK - 1) and {b for b, _, _ in decode_calls} == {4}
    rotating = sum(r for _, r, _ in decode_calls)
    mla = sum(m for _, _, m in decode_calls)
    if family == "gpt_oss":
        assert rotating == layers // 2 * (N_TOK - 1) and mla == 0
    elif family == "deepseek_v2":
        assert mla == len(decode_calls) and rotating == 0
    else:
        assert rotating == mla == 0


def test_partial_batch_and_leavers(tiny_llama_dir):
    """A member leaves after step 2: later frames with fewer members keep
    the remaining stream exact."""
    prompts = {"a": [256, 72, 101], "b": [7, 3, 11, 7]}
    dec = DecodingParams(temperature=0.0)
    want = {n: _solo_stream(tiny_llama_dir, prompts[n], dec, N_TOK) for n in prompts}
    shards = _shards(tiny_llama_dir, 4)
    got = {n: [_prefill(shards, n, prompts[n], dec)] for n in prompts}
    pos = {n: len(prompts[n]) for n in prompts}
    for step in range(1, N_TOK):
        live = list(prompts) if step < 3 else ["b"]
        finals = _step(shards, [(n, got[n][-1], pos[n], dec) for n in live], step)
        for n in live:
            got[n].append(int(finals[n]["token_id"]))
            pos[n] += 1
    assert got["a"] == want["a"][:3] and got["b"] == want["b"]


def test_single_shard_ring_lanes(tiny_llama_dir):
    """A one-shard ring (head and tail) embeds, steps and samples in one
    batched step; streams still match solo."""
    dec = DecodingParams(temperature=0.0)
    split = ([0, 1, 2, 3],)
    want = _solo_stream(tiny_llama_dir, [256, 72, 101], dec, 5, split)
    (sc,) = _shards(tiny_llama_dir, 2, split)
    got, other = [_prefill([sc], "x", [256, 72, 101], dec)], [_prefill([sc], "y", [7, 3, 11], dec)]
    for step in range(1, 5):
        finals = _step([sc], [("x", got[-1], 2 + step, dec), ("y", other[-1], 2 + step, dec)], step)
        got.append(int(finals["x"]["token_id"]))
        other.append(int(finals["y"]["token_id"]))
    assert got == want


def test_faulted_lane_fails_alone(tiny_llama_dir):
    """A member with a stale position fails alone, every step; its
    batchmate's stream continues exactly."""
    dec = DecodingParams(temperature=0.0)
    want_b = _solo_stream(tiny_llama_dir, [7, 3, 11, 7], dec, 4)
    shards = _shards(tiny_llama_dir, 2)
    tok_a = _prefill(shards, "a", [256, 72], dec)
    got_b = [_prefill(shards, "b", [7, 3, 11, 7], dec)]
    for step in range(1, 4):
        finals = _step(shards, [("a", tok_a, 99, dec), ("b", got_b[-1], 3 + step, dec)], step)
        assert finals["a"]["token_id"] == -1 and finals["a"]["error"]
        assert not finals["b"].get("error")
        got_b.append(int(finals["b"]["token_id"]))
    assert got_b == want_b


def test_unknown_and_all_faulted_members_fail_alone(tiny_llama_dir):
    """A member with no prefilled session faults at adoption, alone; a frame
    whose every member faults comes back as one error final each, and the
    pool still serves a healthy member afterwards."""
    dec = DecodingParams(temperature=0.0)
    shards = _shards(tiny_llama_dir, 2)
    tok = _prefill(shards, "live", [256, 72], dec)
    finals = _step(shards, [("ghost", 5, 3, dec), ("live", tok, 2, dec)], 1)
    assert finals["ghost"]["token_id"] == -1 and "no prefilled session" in finals["ghost"]["error"]
    live = int(finals["live"]["token_id"])
    assert live >= 0
    finals = _step(shards, [("g1", 5, 3, dec), ("g2", 6, 4, dec)], 1)
    assert all(f["token_id"] == -1 and f["error"] for f in finals.values()) and len(finals) == 2
    finals = _step(shards, [("live", live, 3, dec)], 2)
    assert finals["live"]["token_id"] >= 0 and not finals["live"].get("error")


def test_lane_pool_full_fails_the_member_as_backpressure(tiny_llama_dir):
    """A third member on a two-lane pool fails with `no free lanes`, which
    the API reads as backpressure (429), as the reference's does."""
    from dnet_tpu_torch.api.inference import BackpressureError, classify_result_error

    dec = DecodingParams(temperature=0.0)
    shards = _shards(tiny_llama_dir, 2)
    toks = {n: _prefill(shards, n, [256, 72 + i], dec) for i, n in enumerate("xyz")}
    finals = _step(shards, [(n, toks[n], 2, dec) for n in "xyz"], 1)
    assert [finals[n]["token_id"] >= 0 for n in "xyz"] == [True, True, False]
    assert "no free lanes" in finals["z"]["error"]
    assert isinstance(classify_result_error(finals["z"]["error"]), BackpressureError)


# ---- concurrent chats on a whole API stack ------------------------------------

CHATS = ["Say hi", "Count to three", "Name a color", "What is water?"]


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


def _lanes_ring(pkg: str, model_dir) -> dict:
    async def go():
        ring = HttpRing(pkg, model_dir)
        try:
            status, text = await ring.start()
            assert status == 200, text
            serial = [await ring.chat(c, max_tokens=10) for c in CHATS]
            conc = await asyncio.gather(*(ring.chat(c, max_tokens=10) for c in CHATS))
            pools = [ring.shards[n].runtime.compute.lane_pool for n in ("s0", "s1")]
            return {"serial": serial, "conc": list(conc), "slots": [p.slots if p else None for p in pools]}
        finally:
            await ring.stop()

    return asyncio.run(go())


def test_concurrent_chats_on_a_lanes_ring_match_the_reference(tiny_llama_dir, monkeypatch):
    from dnet_tpu_torch.obs import metric

    monkeypatch.setenv("DNET_API_RING_LANES", "4")
    reset_settings_cache()
    try:
        depth = metric("dnet_lane_flush_depth")
        n0, s0 = depth.count, depth.sum
        port = _lanes_ring("dnet_tpu_torch", tiny_llama_dir)
        n1, s1 = depth.count, depth.sum
        ref = _lanes_ring("dnet_tpu", tiny_llama_dir)
    finally:
        reset_settings_cache()
    assert port["slots"] == [4, 4]
    for got in (port["serial"], port["conc"], ref["serial"], ref["conc"]):
        assert all(status == 200 and "data: [DONE]" in text for status, text in got)
    norm = lambda rows: [_normalize(text) for _, text in rows]  # noqa: E731
    assert norm(port["conc"]) == norm(ref["conc"]) == norm(port["serial"]) == norm(ref["serial"])
    # the concurrent chats shared frames: more members a flush than one
    assert n1 > n0 and (s1 - s0) / (n1 - n0) > 1.0
