"""The port's batched engine in its dense-slot mode (DNET_KV_PAGED unset)
against dnet_tpu's default BatchedEngine, which is dense, on the same
weights: plain f32 and bf16 caches and the int8 / packed-int4 caches.

Mirrors tests/test_batch_engine.py:32-110,180: interleaved requests,
frozen inactive lanes, R-step budget chunks, and a seeded sampled lane
immune to other traffic.  Greedy streams must be identical token for token
and logprobs within 2e-3 (the repo's parity tolerance).  The reference runs
its dense vmapped step on the CPU; the port's plain decode version attends
each lane's [0, pos + 1) slots through the lengths vector.  A seeded
sampled request is checked within the port (torch.Generator's stream
cannot match jax.random's).
"""

import json

import numpy as np
import pytest
import torch

from dnet_tpu.config import reset_settings_cache
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.batch import BatchedEngine
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.kvcache import cache_nbytes
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.models import ModelConfig
from dnet_tpu_torch.models.convert import from_jax_params

pytestmark = pytest.mark.core

MAX_SEQ = 64
LP_TOL = 2e-3
PROMPTS = {
    "va": [256, 72, 101],
    "vb": [256, 84, 104, 105, 110, 3, 9, 12, 44, 7, 81],
    "vc": list(range(100, 118)),
}
# (KV dtype, quant bits): the param dtype's cache, bf16 under f32 params
# (DNET_KV_BITS=16), int8 and packed int4
KV_FORMS = {"f32": (None, 0), "bf16": ("bfloat16", 0), "q8": (None, 8), "q4": (None, 4)}


@pytest.fixture(scope="module", autouse=True)
def dense_env():
    import os

    saved = {k: os.environ.pop(k, None) for k in ("DNET_KV_PAGED", "DNET_KV_RAGGED", "DNET_FLASH_INTERPRET")}
    reset_settings_cache()
    yield
    for k, v in saved.items():
        if v is not None:
            os.environ[k] = v
    reset_settings_cache()


@pytest.fixture(scope="module", params=list(KV_FORMS))
def form(request):
    return request.param


@pytest.fixture(scope="module")
def ref(tiny_llama_dir, form):
    from dnet_tpu.core.batch import BatchedEngine as RefBatched

    kv_dtype, bits = KV_FORMS[form]
    eng = RefBatched(tiny_llama_dir, slots=4, max_seq=MAX_SEQ, param_dtype="float32",
                     kv_dtype=kv_dtype, kv_quant_bits=bits)
    assert eng.kv is not None and eng.kv_pool is None  # the dense mode
    return eng


@pytest.fixture(scope="module")
def weights(tiny_llama_dir):
    from dnet_tpu.core.engine import LocalEngine as RefEngine

    ref_local = RefEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32")
    cfg = ModelConfig.from_hf(json.loads((tiny_llama_dir / "config.json").read_text()))
    return (cfg,) + from_jax_params(
        {k: np.asarray(v) for k, v in ref_local.window_params.items()},
        {g: {k: np.asarray(a) for k, a in leaves.items()} for g, leaves in ref_local.edge_params.items()},
        cfg, "cpu",
    )


def _port(weights, form, slots=4):
    cfg, window, edge = weights
    kv_dtype, bits = KV_FORMS[form]
    return BatchedEngine.from_params(cfg, window, edge, slots=slots, max_seq=MAX_SEQ, param_dtype="float32",
                                     device="cpu", kv_dtype=kv_dtype, kv_quant_bits=bits)


@pytest.fixture(scope="module")
def port(weights, form):
    return _port(weights, form)


def _first(a) -> float:
    return np.asarray(a).reshape(-1)[0].item()


def _interleaved(eng, dec, steps=6, budgets=False):
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


def test_dense_mode_and_its_cache(port, form):
    kv_dtype, bits = KV_FORMS[form]
    assert port.kv_pool is None
    cfg = port.model.kv_config(len(port.model.layers), 4, MAX_SEQ, port.eng.kv_dtype, bits)
    stats = port.stats()
    assert stats["kv_mode"] == "dense" and stats["kv_quant_bits"] == bits
    assert stats["kv_bytes"] == cache_nbytes(cfg)
    want = {0: getattr(torch, kv_dtype or "float32"), 8: torch.int8, 4: torch.uint8}[bits]
    assert port.kv["k"].dtype == want and ("k_scale" in port.kv) == bool(bits)


def test_interleaved_requests_match_the_reference(port, ref):
    want = _interleaved(ref, RefDecoding(temperature=0.0, logprobs=True, top_logprobs=3))
    got = _interleaved(port, DecodingParams(temperature=0.0, logprobs=True, top_logprobs=3))
    _assert_streams_match(got, want)
    assert not port.slot_of


def test_budget_chunks_match_the_reference_and_serial_steps(port, ref, monkeypatch):
    """R-step chunks (16/8/4/2 wide, extras buffered) give the serial
    stream; the reference's fused chunks give the same tokens."""
    want = _interleaved(ref, RefDecoding(temperature=0.0, logprobs=True), steps=12, budgets=True)
    dec = DecodingParams(temperature=0.0, logprobs=True)
    widths = []
    dispatch = port._dispatch_dense

    def counted(order, lanes, active, R, *rest):
        widths.append(R)
        return dispatch(order, lanes, active, R, *rest)

    monkeypatch.setattr(port, "_dispatch_dense", counted)
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


def test_single_sequence_matches_the_local_engine(port, weights, form):
    cfg, window, edge = weights
    kv_dtype, bits = KV_FORMS[form]
    local = LocalEngine.from_params(cfg, window, edge, max_seq=MAX_SEQ, param_dtype="float32", device="cpu",
                                    kv_dtype=kv_dtype, kv_quant_bits=bits)
    ids = PROMPTS["vb"]
    want = [r.token_id for r in local.generate(ids, DecodingParams(), max_tokens=20, nonce="l")]
    assert [r.token_id for r in port.generate(ids, DecodingParams(), max_tokens=20, nonce="l")] == want


def test_slot_row_holds_the_prefilled_cache(port):
    """_move_to_slot copies the staged row's live slots, codes and scales
    alike, into the slot's row."""
    dec = DecodingParams(temperature=0.0)
    port.end_session("m")
    sess = port.eng.new_session("m")
    port.eng.prefill("m", PROMPTS["vc"])
    staged = {name: t[:, 0, : sess.pos].clone() for name, t in sess.kv.items()}
    port.adopt_prefilled("m", port.eng.prefill("m", [5]), dec)
    slot = port.slot_of["m"]
    for name, t in staged.items():
        assert torch.equal(port.kv[name][:, slot, : t.shape[1]], t)
    port.end_session("m")


def test_seeded_sampling_immune_to_other_traffic(weights, form):
    """Steps that exclude a seeded request advance neither its counts nor
    its random stream."""
    dec = DecodingParams(temperature=1.0, seed=42, repetition_penalty=1.3)
    other = DecodingParams(temperature=0.0)

    def run(noise_steps, budgets):
        eng = _port(weights, form)
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


def test_full_sequence_stops_at_max_seq(weights):
    """A lane that reaches max_seq fails alone; its write never clamps."""
    eng = _port(weights, "q8", slots=2)
    dec = DecodingParams(temperature=0.0)
    t = int(_first(eng.prefill_and_sample("f", list(range(1, MAX_SEQ)), dec).token))
    to = int(_first(eng.prefill_and_sample("o", [256, 65], dec).token))
    out, errs = eng.decode_batch({"f": (t, dec), "o": (to, dec)}, budgets={"f": 8, "o": 8})
    assert not errs and eng.pos[eng.slot_of["f"]] == MAX_SEQ
    out, errs = eng.decode_batch({"f": (int(_first(out["f"].token)), dec), "o": (int(_first(out["o"].token)), dec)})
    assert "max_seq" in errs["f"] and "o" in out
