"""Prompt-lookup speculative decoding in the port against dnet_tpu's.

The draft, the acceptance and the history writes (core/spec.py) equal the
reference's bit for bit on the same numpy inputs (a vector of lane
positions against the reference's per-lane calls, as its batched engine
vmaps them).  The engines' speculative greedy streams equal both the
reference's speculative stream and the port's plain stream on the same
tiny checkpoints (llama, deepseek_v2), single sequence and on dense
batched slots, where lanes advance by their own acceptance (mirroring
tests/test_spec_decode.py).  The reference runs its CPU path (the verify
block's T = 5 is below its kernel gate's T >= 8, so both packages' verify
attends densely there; the port's through the prefill kernel's plain
version)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dnet_tpu.core import spec as ref_spec
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core import spec
from dnet_tpu_torch.core.types import DecodingParams

pytestmark = pytest.mark.core

MAX_SEQ = 128
GREEDY = DecodingParams(temperature=0.0)
REPEATING = [1, 7, 3, 11, 1, 7]  # a repeated bigram: drafts fire


def _hists(seed: int, B: int = 4, S: int = 40, vocab: int = 5) -> np.ndarray:
    """Histories over a small vocabulary, so that n-grams repeat."""
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


# ---- primitives ----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("pos", [0, 1, 2, 3, 4, 17, 39, 40])
@pytest.mark.parametrize("lookahead,ngram", [(4, 2), (3, 3), (8, 1)])
def test_ngram_draft_equals_reference(seed, pos, lookahead, ngram):
    """Every lane's draft at a shared position, edge positions included
    (a key before the buffer's start, a continuation past its end)."""
    hist = _hists(seed)
    want = np.asarray(ref_spec.ngram_draft(jnp.asarray(hist), jnp.int32(pos), lookahead, ngram))
    got = spec.ngram_draft(torch.from_numpy(hist).long(), pos, lookahead, ngram).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_ngram_draft_per_lane_positions(seed):
    """A vector of lane positions drafts each lane as the reference's
    single-lane call at that lane's position (its batched engine's vmap)."""
    hist = _hists(seed, B=6)
    pos = np.random.default_rng(100 + seed).integers(0, 41, size=6)
    got = spec.ngram_draft(torch.from_numpy(hist).long(), torch.from_numpy(pos), 4).numpy()
    for b in range(6):
        want = np.asarray(ref_spec.ngram_draft(jnp.asarray(hist[b : b + 1]), jnp.int32(pos[b]), 4))
        np.testing.assert_array_equal(got[b : b + 1], want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("pos", [0, 1, 2, 5, 23, 39])
def test_ngram_draft_np_equals_reference_and_device(seed, pos):
    """The host twin equals the reference's host twin, and (past the
    buffer's start) the device draft."""
    hist = _hists(seed, B=1)[0]
    want = ref_spec.ngram_draft_np(hist, pos, 4)
    got = spec.ngram_draft_np(hist, pos, 4)
    np.testing.assert_array_equal(got, want)
    if pos >= 3 and pos + 4 <= len(hist):
        dev = spec.ngram_draft(torch.from_numpy(hist[None]).long(), pos, 4).numpy()[0]
        np.testing.assert_array_equal(dev, got)


def test_ngram_draft_finds_latest_match():
    hist = torch.zeros((1, 32), dtype=torch.int64)
    hist[0, :10] = torch.tensor([5, 6, 7, 8, 5, 6, 9, 1, 5, 6])
    assert spec.ngram_draft(hist, 10, 3)[0].tolist() == [9, 1, 5]
    hist[0, :4] = torch.tensor([1, 2, 3, 4])
    hist[0, 4:] = 0
    assert spec.ngram_draft(hist, 4, 4)[0].tolist() == [4, 4, 4, 4]  # no match: repeat the last


@pytest.mark.parametrize("seed", range(8))
def test_accept_drafts_equals_reference(seed):
    rng = np.random.default_rng(seed)
    drafts = rng.integers(0, 3, size=(5, 4)).astype(np.int32)
    preds = np.concatenate([np.where(rng.random((5, 4)) < 0.7, drafts, rng.integers(0, 3, (5, 4))),
                            rng.integers(0, 3, (5, 1))], axis=1).astype(np.int32)
    n_want, out_want = ref_spec.accept_drafts(jnp.asarray(preds), jnp.asarray(drafts))
    n_got, out_got = spec.accept_drafts(torch.from_numpy(preds), torch.from_numpy(drafts))
    np.testing.assert_array_equal(n_got.numpy(), np.asarray(n_want))
    np.testing.assert_array_equal(out_got.numpy(), np.asarray(out_want))


def test_accept_drafts_sentinel():
    n, out = spec.accept_drafts(torch.tensor([[7, 8, 9, 10]]), torch.tensor([[7, 8, 11]]))
    assert int(n[0]) == 2 and out[0].tolist() == [7, 8, 9, -1]
    n, out = spec.accept_drafts(torch.tensor([[7, 8, 11, 3]]), torch.tensor([[7, 8, 11]]))
    assert int(n[0]) == 3 and out[0].tolist() == [7, 8, 11, 3]
    n, out = spec.accept_drafts(torch.tensor([[9, 8, 11, 3]]), torch.tensor([[7, 8, 11]]))
    assert int(n[0]) == 0 and out[0].tolist() == [9, -1, -1, -1]


@pytest.mark.parametrize("pos", [0, 3, 6, 9])
def test_commit_history_equals_reference(pos):
    """The whole block written, -1 as 0, the start clamped at the end."""
    hist = np.arange(20, dtype=np.int32).reshape(2, 10)
    tokens = np.asarray([[9, 9, -1], [4, -1, -1]], dtype=np.int32)
    want = np.asarray(ref_spec.commit_history(jnp.asarray(hist), jnp.int32(pos), jnp.asarray(tokens), jnp.int32(2)))
    got = spec.commit_history(torch.from_numpy(hist.copy()).long(), pos, torch.from_numpy(tokens), 2)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- engines ---------------------------------------------------------------


@pytest.fixture(scope="module")
def deepseek_dir(tmp_path_factory):
    from tests.fakes.checkpoints import make_tiny_deepseek_v2

    d = tmp_path_factory.mktemp("spec_ds")
    make_tiny_deepseek_v2(d)
    return d


def _port(d, **kw):
    from dnet_tpu_torch.core.engine import LocalEngine

    return LocalEngine(d, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", **kw)


def _ref(d, **kw):
    from dnet_tpu.core.engine import LocalEngine

    return LocalEngine(d, max_seq=MAX_SEQ, param_dtype="float32", **kw)


def _stream(eng, ids, n, dec):
    return [r.token_id for r in eng.generate(ids, dec, max_tokens=n)]


@pytest.mark.parametrize("family", ["llama", "deepseek_v2"])
def test_spec_stream_equals_plain_and_reference(tiny_llama_dir, deepseek_dir, family):
    """The port's speculative greedy stream equals its plain stream and the
    reference's speculative stream, and its blocks emit what the
    reference's do."""
    d = tiny_llama_dir if family == "llama" else deepseek_dir
    port, ref = _port(d, spec_lookahead=4), _ref(d, spec_lookahead=4)
    got = _stream(port, REPEATING, 24, GREEDY)
    assert got == _stream(_port(d), REPEATING, 24, GREEDY)
    assert got == _stream(ref, REPEATING, 24, RefDecoding(temperature=0.0))
    assert port.spec_blocks > 0 and port.stats()["spec_emitted"] >= port.stats()["spec_blocks"]


def test_spec_blocks_chain_and_emit_exactly(tiny_llama_dir):
    """decode_spec advances pos by exactly the emitted count, chains from
    the device-resident last token, and each block emits what the
    reference's block at the same state emits."""
    port, ref = _port(tiny_llama_dir, spec_lookahead=4), _ref(tiny_llama_dir, spec_lookahead=4)
    ids = [1, 7, 3, 11, 1, 7, 3, 11, 1]
    rdec = RefDecoding(temperature=0.0)
    port.prefill("s", ids)
    ref.prefill("s", ids)
    got, want = [], []
    tok = ids[-1]
    while len(got) < 16:
        a = [int(r.token[0]) for r in port.decode_spec("s", tok if not got else None, GREEDY, 16 - len(got))]
        b = [int(r.token[0]) for r in ref.decode_spec("s", tok if not want else None, rdec, 16 - len(want))]
        assert a == b and a
        got += a
        want += b
    assert port.sessions["s"].pos == ref.sessions["s"].pos == len(ids) + 16


def test_spec_falls_back_to_a_plain_step_at_the_end(tiny_llama_dir):
    """Without room for L+1 rows the block is one plain step, as the
    reference's."""
    port = _port(tiny_llama_dir, spec_lookahead=4)
    ids = list(range(1, MAX_SEQ - 3))
    r = port.prefill_and_sample("e", ids, GREEDY)
    out = port.decode_spec("e", int(r.token[0]), GREEDY, 8)
    assert len(out) == 1 and port.sessions["e"].spec_blocks == 0


def test_spec_eligibility(tiny_llama_dir, tmp_path_factory):
    """Greedy only, without logprobs, penalty or bias; a plain engine never;
    gpt_oss's rotating caches never, and it serves greedy through the plain
    path with speculation set, its stream the reference's."""
    from tests.fakes.checkpoints import make_tiny_gpt_oss

    eng = _port(tiny_llama_dir, spec_lookahead=4)
    assert eng.spec_eligible(DecodingParams(temperature=0.0))
    assert not eng.spec_eligible(DecodingParams(temperature=0.7))
    assert not eng.spec_eligible(DecodingParams(temperature=0.0, logprobs=True))
    assert not eng.spec_eligible(DecodingParams(temperature=0.0, repetition_penalty=1.3))
    assert not eng.spec_eligible(DecodingParams(temperature=0.0, logit_bias={5: 1.0}))
    assert not _port(tiny_llama_dir).spec_eligible(GREEDY)
    d = tmp_path_factory.mktemp("spec_oss")
    make_tiny_gpt_oss(d)
    oss = _port(d, spec_lookahead=4)
    assert not oss.spec_eligible(GREEDY)
    got = _stream(oss, REPEATING, 12, GREEDY)
    assert oss.spec_blocks == 0
    assert got == _stream(_ref(d, spec_lookahead=4), REPEATING, 12, RefDecoding(temperature=0.0))


def test_spec_worthwhile_gate(tiny_llama_dir):
    """After the warm-up, a session below 1.5 tokens a block takes plain
    steps; unknown sessions do not gate."""
    eng = _port(tiny_llama_dir, spec_lookahead=4)
    eng.prefill("g", [1, 2, 3])
    sess = eng.sessions["g"]
    assert eng.spec_worthwhile("g")
    sess.spec_blocks, sess.spec_emitted = 8, 8
    assert not eng.spec_worthwhile("g")
    sess.spec_emitted = 16
    assert eng.spec_worthwhile("g")
    assert eng.spec_worthwhile("unknown")
    assert (eng.SPEC_WARMUP_BLOCKS, eng.SPEC_MIN_TOKENS_PER_BLOCK) == (4, 1.5)


def test_streamed_weights_do_not_speculate(tiny_llama_dir):
    """A weight-streaming plan keeps the setting but never speculates (the
    reference's spec_eligible), and serves the plain stream."""
    eng = _port(tiny_llama_dir, spec_lookahead=4, window_size=2, residency_size=1)
    assert eng.plan.streams_weights and not eng.spec_eligible(GREEDY)
    assert _stream(eng, REPEATING, 10, GREEDY) == _stream(_port(tiny_llama_dir), REPEATING, 10, GREEDY)
    eng.close()


# ---- dense batched slots ----------------------------------------------------------


@pytest.fixture(scope="module")
def batched(tiny_llama_dir):
    from dnet_tpu_torch.core.batch import BatchedEngine

    eng = BatchedEngine(tiny_llama_dir, slots=4, max_seq=MAX_SEQ, param_dtype="float32", device="cpu",
                        spec_lookahead=4)
    yield eng
    eng.close()


def _drive(eng, prompts: dict, decs: dict, n: int) -> dict:
    toks = {k: [int(eng.prefill_and_sample(k, p, decs[k]).token[0])] for k, p in prompts.items()}
    while any(len(t) < n for t in toks.values()):
        live = {k: t for k, t in toks.items() if len(t) < n}
        out, errs = eng.decode_batch({k: (t[-1], decs[k]) for k, t in live.items()},
                                     budgets={k: n - len(t) for k, t in live.items()})
        assert not errs
        for k, r in out.items():
            toks[k].append(int(r.token[0]))
    for k in prompts:
        eng.end_session(k)
    return {k: t[:n] for k, t in toks.items()}


def test_batched_spec_matches_serial_and_reference(tiny_llama_dir, batched):
    """Greedy lanes speculating together equal serial plain streams, and
    the reference's speculating batched engine on the same schedule."""
    from dnet_tpu.core.batch import BatchedEngine as RefBatched

    prompts = {"s0": [7, 3, 11, 7, 3, 11, 7, 3], "s1": [5, 9, 5, 9, 5, 9], "s2": [250, 13, 99]}
    got = _drive(batched, prompts, {k: GREEDY for k in prompts}, 12)
    plain = _port(tiny_llama_dir)
    assert got == {k: _stream(plain, p, 12, GREEDY) for k, p in prompts.items()}
    ref = RefBatched(tiny_llama_dir, slots=4, max_seq=MAX_SEQ, param_dtype="float32", spec_lookahead=4,
                     kv_paged=False)
    assert got == _drive(ref, prompts, {k: RefDecoding(temperature=0.0) for k in prompts}, 12)
    assert batched.stats()["spec_blocks"] > 0


def test_batched_spec_lanes_advance_unevenly(batched):
    """One verify block: a repetitive lane accepts more than a plain one,
    each lane advances by its own count (>= 1), and the stats count one
    block a lane."""
    rep, plain = [7, 3, 11, 7, 3, 11, 7, 3, 11, 7, 3], [250, 13, 99]
    ra = batched.prefill_and_sample("rep", rep, GREEDY)
    rb = batched.prefill_and_sample("plain", plain, GREEDY)
    pos0 = {n: int(batched.pos[batched.slot_of[n]]) for n in ("rep", "plain")}
    out, errs = batched.decode_batch({"rep": (int(ra.token[0]), GREEDY), "plain": (int(rb.token[0]), GREEDY)},
                                     budgets={"rep": 16, "plain": 16})
    assert not errs and set(out) == {"rep", "plain"}
    adv = {n: int(batched.pos[batched.slot_of[n]]) - pos0[n] for n in ("rep", "plain")}
    assert adv["rep"] >= 1 and adv["plain"] >= 1 and adv["rep"] > adv["plain"]
    assert batched._spec_stats["rep"][0] == 1 and batched._spec_stats["plain"][0] == 1
    batched.end_session("rep")
    batched.end_session("plain")


def test_batched_spec_mixed_with_sampled(tiny_llama_dir, batched):
    """A greedy lane speculates while a seeded sampled lane takes the plain
    step in the same decode_batch calls; each equals its serial stream."""
    sampled = DecodingParams(temperature=0.9, top_p=0.9, seed=42)
    got = _drive(batched, {"g": [7, 3, 11, 7, 3, 11, 7], "s": [250, 99, 13]}, {"g": GREEDY, "s": sampled}, 8)
    plain = _port(tiny_llama_dir)
    assert got["g"] == _stream(plain, [7, 3, 11, 7, 3, 11, 7], 8, GREEDY)
    assert got["s"] == _stream(plain, [250, 99, 13], 8, sampled)


def test_batched_spec_deepseek_matches_serial(deepseek_dir):
    """deepseek_v2's MLA lanes verify through the per-lane form at
    (qk, v) head widths that differ."""
    from dnet_tpu_torch.core.batch import BatchedEngine

    eng = BatchedEngine(deepseek_dir, slots=3, max_seq=MAX_SEQ, param_dtype="float32", device="cpu",
                        spec_lookahead=3)
    prompts = {"a": REPEATING * 2, "b": [9, 8, 7, 9, 8, 7, 9]}
    got = _drive(eng, prompts, {k: GREEDY for k in prompts}, 10)
    plain = _port(deepseek_dir)
    assert got == {k: _stream(plain, p, 10, GREEDY) for k, p in prompts.items()}
    assert eng.spec_blocks > 0


def test_batched_spec_off_where_the_reference_turns_it_off(tiny_llama_dir, monkeypatch, tmp_path):
    """Under paged slots and for gpt_oss's rings speculation is off with the
    reference's warnings, and the streams are the plain ones."""
    from dnet_tpu_torch.core.batch import BatchedEngine
    from tests.fakes.checkpoints import make_tiny_gpt_oss

    monkeypatch.setenv("DNET_KV_PAGED", "1")
    monkeypatch.setenv("DNET_KV_BLOCK_TOKENS", "8")
    paged = BatchedEngine(tiny_llama_dir, slots=2, max_seq=MAX_SEQ, param_dtype="float32", device="cpu",
                          spec_lookahead=4)
    assert paged.kv_pool is not None and paged.spec_lookahead == 0
    got = _drive(paged, {"a": REPEATING}, {"a": GREEDY}, 8)
    assert got["a"] == _stream(_port(tiny_llama_dir), REPEATING, 8, GREEDY)
    monkeypatch.delenv("DNET_KV_PAGED")
    make_tiny_gpt_oss(tmp_path)
    oss = BatchedEngine(tmp_path, slots=2, max_seq=64, param_dtype="float32", device="cpu", spec_lookahead=4)
    assert oss.spec_lookahead == 0 and oss.hist is None
