"""The port's continuously batched engine (core/batch.py) against dnet_tpu's
BatchedEngine in its paged + ragged mode on the same weights.

The reference runs with DNET_KV_PAGED=1 DNET_KV_RAGGED=1 and its Pallas
kernels in interpret mode, 8-token blocks; its weights are carried across
to the port by models/convert.py.  Greedy streams must be identical token
for token and logprobs within 2e-3 (the repo's parity tolerance), through
interleaved ragged requests, a partial batch, and R-step budget chunks.  A
seeded sampled request must not depend on other traffic (the port's
torch.Generator stream cannot match jax.random's, so that one is checked
within the port)."""

import json
import os

import numpy as np
import pytest

from dnet_tpu.config import reset_settings_cache
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.api.inference import BackpressureError, EngineCapabilityError, classify_result_error
from dnet_tpu_torch.core.batch import BatchedEngine
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.kv import KVPoolExhausted
from dnet_tpu_torch.models import ModelConfig
from dnet_tpu_torch.models.convert import from_jax_params

pytestmark = pytest.mark.core

MAX_SEQ = 64
LP_TOL = 2e-3
ENV = {"DNET_KV_PAGED": "1", "DNET_KV_RAGGED": "1", "DNET_FLASH_INTERPRET": "1",
       "DNET_KV_BLOCK_TOKENS": "8"}
# ragged prompt lengths: inside the first block, across one edge, across two
PROMPTS = {
    "va": [256, 72, 101],
    "vb": [256, 84, 104, 105, 110, 3, 9, 12, 44, 7, 81],
    "vc": list(range(100, 118)),
}


def _set_env(values):
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    reset_settings_cache()
    return saved


@pytest.fixture(scope="module")
def paged_env():
    saved = _set_env(ENV)
    yield
    _set_env(saved)


@pytest.fixture(scope="module")
def ref(tiny_llama_dir, paged_env):
    from dnet_tpu.core.batch import BatchedEngine as RefBatched

    eng = RefBatched(tiny_llama_dir, slots=4, max_seq=MAX_SEQ, param_dtype="float32", kv_paged=True)
    assert eng.kv_ragged is True
    return eng


@pytest.fixture(scope="module")
def weights(tiny_llama_dir, ref):
    cfg = ModelConfig.from_hf(json.loads((tiny_llama_dir / "config.json").read_text()))
    window, edge = from_jax_params(
        {k: np.asarray(v) for k, v in ref.eng.window_params.items()},
        {g: {k: np.asarray(a) for k, a in leaves.items()} for g, leaves in ref.eng.edge_params.items()},
        cfg, "cpu",
    )
    return cfg, window, edge


def _port(weights, slots=4, **kw):
    cfg, window, edge = weights
    return BatchedEngine.from_params(cfg, window, edge, slots=slots, max_seq=MAX_SEQ,
                                     param_dtype="float32", device="cpu", **kw)


@pytest.fixture(scope="module")
def port(weights):
    return _port(weights)


def _first(a) -> float:
    return np.asarray(a).reshape(-1)[0].item()


def _interleaved(eng, dec, steps=6, budgets=None):
    """Every prompt prefilled, then `steps - 1` batched steps over all of
    them; returns nonce -> [(token, logprob), ...]."""
    got = {}
    for n, ids in PROMPTS.items():
        eng.end_session(n)
        r = eng.prefill_and_sample(n, ids, dec)
        got[n] = [(int(_first(r.token)), _first(r.logprob))]
    for step in range(1, steps):
        reqs = {n: (got[n][-1][0], dec) for n in PROMPTS}
        out, errs = eng.decode_batch(reqs, budgets={n: steps - step for n in reqs} if budgets else None)
        assert not errs, errs
        for n, r in out.items():
            got[n].append((int(_first(r.token)), _first(r.logprob)))
    for n in PROMPTS:
        eng.end_session(n)
    return got


def _assert_streams_match(got, want):
    for n in want:
        assert [t for t, _ in got[n]] == [t for t, _ in want[n]], n
        np.testing.assert_allclose([lp for _, lp in got[n]], [lp for _, lp in want[n]], atol=LP_TOL)


def test_interleaved_ragged_requests_match_the_reference(port, ref):
    want = _interleaved(ref, RefDecoding(temperature=0.0, logprobs=True, top_logprobs=3))
    got = _interleaved(port, DecodingParams(temperature=0.0, logprobs=True, top_logprobs=3))
    _assert_streams_match(got, want)
    port.kv_pool.check_conservation([])
    assert port.kv_pool.used == 0 and not port.slot_of


def test_budget_chunks_match_the_reference_and_serial_steps(port, ref, monkeypatch):
    """R-step chunks (16/8/4/2 wide, extras buffered) give the serial
    stream; the reference's fused chunks give the same tokens."""
    want = _interleaved(ref, RefDecoding(temperature=0.0, logprobs=True), steps=12, budgets=True)
    dec = DecodingParams(temperature=0.0, logprobs=True)
    widths = []
    dispatch = port._dispatch_ragged

    def counted(order, lanes, active, R, *rest):
        widths.append(R)
        return dispatch(order, lanes, active, R, *rest)

    monkeypatch.setattr(port, "_dispatch_ragged", counted)
    steps0 = port.decode_steps
    got = _interleaved(port, dec, steps=12, budgets=True)
    assert widths == [8, 2, 1] and port.decode_steps - steps0 == 11
    _assert_streams_match(got, want)
    widths.clear()
    _assert_streams_match(_interleaved(port, dec, steps=12), got)
    assert widths == [1] * 11


def test_partial_batch_freezes_inactive_lanes(port, ref):
    """A lane that skips steps neither moves nor corrupts its KV: a2 runs
    alone for two steps, then b2 catches up beside it."""

    def run(eng, dec):
        for n in ("a2", "b2"):
            eng.end_session(n)
        ta = int(_first(eng.prefill_and_sample("a2", PROMPTS["vb"], dec).token))
        tb = int(_first(eng.prefill_and_sample("b2", PROMPTS["vc"], dec).token))
        got_a, got_b = [ta], [tb]
        for _ in range(2):
            ta = int(_first(eng.decode_batch({"a2": (ta, dec)})[0]["a2"].token))
            got_a.append(ta)
        for _ in range(4):
            req = {"b2": (tb, dec)}
            if len(got_a) < 5:
                req["a2"] = (ta, dec)
            out, errs = eng.decode_batch(req)
            assert not errs
            tb = int(_first(out["b2"].token))
            got_b.append(tb)
            if "a2" in out:
                ta = int(_first(out["a2"].token))
                got_a.append(ta)
        for n in ("a2", "b2"):
            eng.end_session(n)
        return got_a, got_b

    want = run(ref, RefDecoding(temperature=0.0))
    assert run(port, DecodingParams(temperature=0.0)) == want


def test_single_sequence_matches_the_local_engine(port, weights):
    cfg, window, edge = weights
    local = LocalEngine.from_params(cfg, window, edge, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    ids = PROMPTS["vb"]
    want = [r.token_id for r in local.generate(ids, DecodingParams(), max_tokens=20, nonce="l")]
    assert [r.token_id for r in port.generate(ids, DecodingParams(), max_tokens=20, nonce="l")] == want


@pytest.mark.parametrize(
    "dec",
    [
        DecodingParams(repetition_penalty=1.5),  # greedy: the lane's counts must grow
        DecodingParams(temperature=0.9, top_k=40, seed=7, repetition_penalty=1.2),
    ],
)
def test_lane_sampling_state_matches_the_local_engine(port, weights, dec):
    """A lane carries its request's penalty counts and random stream from
    prefill on: by single steps and by budget chunks, beside another lane,
    it samples what the single-sequence engine samples."""
    cfg, window, edge = weights
    local = LocalEngine.from_params(cfg, window, edge, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    ids = PROMPTS["vc"]
    want = [r.token_id for r in local.generate(ids, dec, max_tokens=14, nonce="l")]
    other = DecodingParams(temperature=1.0, seed=3)
    for budgets in (False, True):
        for n in ("l", "o"):
            port.end_session(n)
        toks = [int(_first(port.prefill_and_sample("l", ids, dec).token))]
        to = int(_first(port.prefill_and_sample("o", PROMPTS["va"], other).token))
        while len(toks) < 14:
            reqs = {"l": (toks[-1], dec), "o": (to, other)}
            out, errs = port.decode_batch(reqs, budgets={"l": 14 - len(toks), "o": 14 - len(toks)}
                                          if budgets else None)
            assert not errs
            toks.append(int(_first(out["l"].token)))
            to = int(_first(out["o"].token))
        assert toks == want, budgets
    for n in ("l", "o"):
        port.end_session(n)


def test_seeded_sampling_immune_to_other_traffic(weights):
    """Steps that exclude a seeded request advance neither its counts nor
    its random stream."""
    dec = DecodingParams(temperature=1.0, seed=42, repetition_penalty=1.3)
    other = DecodingParams(temperature=0.0)

    def run(noise_steps, budgets):
        eng = _port(weights)
        ts = int(_first(eng.prefill_and_sample("s", PROMPTS["va"], dec).token))
        to = int(_first(eng.prefill_and_sample("o", PROMPTS["vb"], other).token))
        toks = [ts]
        for _ in range(noise_steps):
            out, _ = eng.decode_batch({"o": (to, other)})
            to = int(_first(out["o"].token))
        for i in range(6):
            out, _ = eng.decode_batch({"s": (ts, dec)}, budgets={"s": 6 - i} if budgets else None)
            ts = int(_first(out["s"].token))
            toks.append(ts)
        eng.close()
        return toks

    want = run(0, False)
    assert run(3, False) == want
    assert run(2, True) == want


def test_logit_bias_per_lane(port):
    da = DecodingParams(temperature=0.0, logit_bias={65: 100.0})
    db = DecodingParams(temperature=0.0, logit_bias={66: 100.0})
    for n in ("a", "b"):
        port.end_session(n)
    port.prefill_and_sample("a", [256, 72], da)
    port.prefill_and_sample("b", [256, 73], db)
    out, errs = port.decode_batch({"a": (65, da), "b": (66, db)})
    assert not errs
    assert (int(_first(out["a"].token)), int(_first(out["b"].token))) == (65, 66)
    for n in ("a", "b"):
        port.end_session(n)


def test_unknown_nonce_fails_alone(port):
    dec = DecodingParams(temperature=0.0)
    port.end_session("ok")
    r = port.prefill_and_sample("ok", [256, 72], dec)
    out, errs = port.decode_batch({"ok": (int(_first(r.token)), dec), "ghost": (5, dec)})
    assert "ok" in out and "ghost" in errs
    port.end_session("ok")


def test_slot_exhaustion_is_typed_backpressure(port):
    dec = DecodingParams(temperature=0.0)
    nonces = [f"fill{i}" for i in range(port.slots)]
    for n in nonces:
        port.prefill_and_sample(n, [256, 65], dec)
    with pytest.raises(RuntimeError, match="no free batch slots") as info:
        port.prefill_and_sample("overflow", [256, 65], dec)
    assert isinstance(classify_result_error(str(info.value)), BackpressureError)
    for n in nonces:
        port.end_session(n)
    port.kv_pool.check_conservation([])


def test_pool_exhaustion_is_typed_backpressure(weights, monkeypatch):
    """A pool of 3 blocks: a 20-token prompt takes all three; a second
    request is refused before prefill, and the first fails alone once it
    needs a fourth block.  Both errors classify as 429 backpressure."""
    monkeypatch.setenv("DNET_KV_POOL_BLOCKS", "3")
    eng = _port(weights, slots=2)
    dec = DecodingParams(temperature=0.0)
    tok = int(_first(eng.prefill_and_sample("big", list(range(100, 120)), dec).token))
    with pytest.raises(KVPoolExhausted, match="paged KV pool exhausted") as info:
        eng.prefill_and_sample("late", [256, 65], dec)
    assert isinstance(classify_result_error(str(info.value)), BackpressureError)
    assert "late" not in eng.slot_of  # its slot was handed back
    for _ in range(4):  # 20 -> 24 tokens fill the third block
        out, errs = eng.decode_batch({"big": (tok, dec)}, budgets={"big": 8})
        assert not errs
        tok = int(_first(out["big"].token))
    out, errs = eng.decode_batch({"big": (tok, dec)})
    assert not out and isinstance(classify_result_error(errs["big"]), BackpressureError)
    eng.kv_pool.check_conservation([eng._tables[eng.slot_of["big"]].blocks])
    eng.end_session("big")
    assert eng.kv_pool.free == 3


@pytest.mark.parametrize(
    "env,kw,match",
    [
        ({}, {"kv_quant_bits": 8}, "dense-gather paged decode is not ported"),  # quantized pool
        ({"DNET_KV_RAGGED": "0"}, {}, "DNET_KV_RAGGED=1"),
        ({"DNET_KV_PAGED": "0"}, {"prefix_cache_size": 4}, "prefix cache"),  # on dense slots
        ({"DNET_KV_BLOCK_TOKENS": "24"}, {}, "divide max_seq"),
    ],
)
def test_refused_configurations(weights, ref, monkeypatch, env, kw, match):
    """The configurations the port refused at load (the refusal's text in
    `match`).  A prefix cache on dense slots still is (HTTP 422: the dense
    snapshot prefix cache, ROADMAP A4, is not ported).  The other three now
    serve as the reference does, its greedy stream equal to the ragged
    reference's (an int8 pool's: the int8 dense slots'): a quantized pool
    and DNET_KV_RAGGED off through the dense-gather decode, a block size
    that does not divide max_seq on dense slots."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    reset_settings_cache()
    if "prefix_cache_size" in kw:
        with pytest.raises(EngineCapabilityError, match="DNET_API_PREFIX_CACHE=4 on dense batched slots"):
            _port(weights, **kw)
        return
    eng = _port(weights, **kw)
    mode = "dense" if match == "divide max_seq" else "paged"
    assert eng.stats()["kv_mode"] == mode and eng.kv_ragged is False
    dec = DecodingParams(temperature=0.0, logprobs=True)
    got = _interleaved(eng, dec, steps=6)
    monkeypatch.undo()
    if kw.get("kv_quant_bits"):
        # an int8 pool: the stream of int8 dense slots, the same kernel over the same codes
        monkeypatch.setenv("DNET_KV_PAGED", "0")
        reset_settings_cache()
        want = _interleaved(_port(weights, **kw), dec, steps=6)
        monkeypatch.undo()
    else:
        reset_settings_cache()
        want = _interleaved(ref, RefDecoding(temperature=0.0, logprobs=True), steps=6)
    reset_settings_cache()
    _assert_streams_match(got, want)


def test_model_without_the_hook_is_refused(weights, ref, monkeypatch):
    """A family without llama's attention body (supports_paged_attend
    False: gpt_oss, deepseek_v2) is refused the ragged kernel only, as the
    reference's ragged_refusal says, and serves through the dense gather;
    a model without the lane hook at all is refused batching at load."""
    from dnet_tpu_torch.models.llama import LlamaRingModel

    monkeypatch.setattr(LlamaRingModel, "supports_paged_attend", False)
    eng = _port(weights)
    assert eng.kv_pool is not None and eng.kv_ragged is False
    dec = DecodingParams(temperature=0.0, logprobs=True)
    _assert_streams_match(_interleaved(eng, dec), _interleaved(ref, RefDecoding(temperature=0.0, logprobs=True)))
    monkeypatch.setattr(LlamaRingModel, "supports_kv_commit", False)
    with pytest.raises(EngineCapabilityError, match="no gated KV writes"):
        _port(weights)
