"""The port's batched engine for gpt_oss and deepseek_v2 (the lane hook,
models/base.py `supports_kv_commit`) against dnet_tpu's BatchedEngine on
the same weights.

- gpt_oss (tests/fakes/checkpoints.py make_tiny_gpt_oss: a W = 8 ring on
  its sliding half) on dense slots at max_seq 64, where every lane's ring
  wraps at its own position, and with DNET_KV_PAGED=1, which both engines
  serve on dense slots (the rings cannot be addressed by blocks);
- deepseek_v2 (MLA: K rows 24 wide, V 12 at the tiny widths) on dense
  slots and under the dense-gather paged decode, plain, int8 and packed
  int4.

Greedy streams must be identical token for token and logprobs within 2e-3
(the repo's parity tolerance), through interleaved requests, R-step budget
chunks and frozen inactive lanes.  The reference runs its dense vmapped
step on the CPU.
"""

import json
import os

import numpy as np
import pytest

from dnet_tpu.config import reset_settings_cache
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.batch import BatchedEngine
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.models import ModelConfig
from dnet_tpu_torch.models.convert import from_jax_params

pytestmark = pytest.mark.core

MAX_SEQ = 64
LP_TOL = 2e-3
PROMPTS = {
    "va": [256, 72, 101],
    "vb": [256, 84, 104, 105, 110, 3, 9, 12, 44, 7, 81],  # longer than the ring
    "vc": list(range(100, 118)),
}
# (family, DNET_KV_PAGED, kv quant bits) -> the KV mode both engines serve
CASES = {
    "gpt_oss-dense": ("gpt_oss", None, 0, "dense"),
    "gpt_oss-paged": ("gpt_oss", "1", 0, "dense"),
    "deepseek_v2-dense": ("deepseek_v2", None, 0, "dense"),
    "deepseek_v2-dense-q8": ("deepseek_v2", None, 8, "dense"),
    "deepseek_v2-dense-q4": ("deepseek_v2", None, 4, "dense"),
    "deepseek_v2-gather": ("deepseek_v2", "1", 0, "paged"),
    "deepseek_v2-gather-q8": ("deepseek_v2", "1", 8, "paged"),
    "deepseek_v2-gather-q4": ("deepseek_v2", "1", 4, "paged"),
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
def family_dirs(tmp_path_factory):
    from tests.fakes.checkpoints import make_tiny_deepseek_v2, make_tiny_gpt_oss

    out = {"gpt_oss": tmp_path_factory.mktemp("oss"), "deepseek_v2": tmp_path_factory.mktemp("ds")}
    make_tiny_gpt_oss(out["gpt_oss"])
    # seed 5: the default seed's greedy stream repeats one token
    make_tiny_deepseek_v2(out["deepseek_v2"], seed=5)
    return out


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    _, paged, _, _ = CASES[request.param]
    saved = _set_env({"DNET_KV_PAGED": paged, "DNET_KV_BLOCK_TOKENS": "8", "DNET_KV_RAGGED": None,
                      "DNET_FLASH_INTERPRET": None, "DNET_KV_POOL_BLOCKS": None})
    yield request.param
    _set_env(saved)


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def engines(case, family_dirs):
    from dnet_tpu.core.batch import BatchedEngine as RefBatched

    family, _, bits, mode = CASES[case]
    d = family_dirs[family]
    ref = RefBatched(d, slots=4, max_seq=MAX_SEQ, param_dtype="float32", kv_quant_bits=bits)
    assert (ref.kv_pool is not None) == (mode == "paged")
    cfg = ModelConfig.from_hf(json.loads((d / "config.json").read_text()))
    window, edge = from_jax_params(_np(ref.eng.window_params), _np(ref.eng.edge_params), cfg, "cpu")
    port = BatchedEngine.from_params(cfg, window, edge, slots=4, max_seq=MAX_SEQ, param_dtype="float32",
                                     device="cpu", kv_quant_bits=bits)
    return ref, port


def _first(a) -> float:
    return np.asarray(a).reshape(-1)[0].item()


def _interleaved(eng, dec, steps=20, budgets=False):
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


def test_kv_mode_and_cache_layout(engines, case):
    family, paged, bits, mode = CASES[case]
    ref, port = engines
    stats = port.stats()
    assert stats["kv_mode"] == mode and stats["kv_ragged"] is False and stats["kv_quant_bits"] == bits
    if family == "gpt_oss":
        W = port.config.sliding_window
        sliding = "a" if port.model.pair_kinds[0] == 1 else "b"
        assert port.kv[sliding]["k"].shape[2] == W < MAX_SEQ  # a ring per slot
        assert port.kv[sliding]["k"].shape[1] == 4
    elif mode == "paged":
        assert port.kv is None and port.kv_store.kv["k"].shape[1:3] == (port.kv_pool.total, 8)
        assert port.kv_pool.total == ref.kv_pool.total


def test_interleaved_requests_match_the_reference(engines):
    """20 steps: the prompts' rings wrap (gpt_oss), every lane at its own
    position; the dense gather crosses block edges per lane."""
    ref, port = engines
    want = _interleaved(ref, RefDecoding(temperature=0.0, logprobs=True, top_logprobs=3))
    got = _interleaved(port, DecodingParams(temperature=0.0, logprobs=True, top_logprobs=3))
    _assert_streams_match(got, want)
    assert not port.slot_of
    if port.kv_pool is not None:
        assert port.kv_pool.used == 0


def test_budget_chunks_match_the_reference(engines):
    ref, port = engines
    want = _interleaved(ref, RefDecoding(temperature=0.0, logprobs=True), steps=12, budgets=True)
    got = _interleaved(port, DecodingParams(temperature=0.0, logprobs=True), steps=12, budgets=True)
    _assert_streams_match(got, want)


def test_partial_batch_freezes_inactive_lanes(engines):
    """a2 runs alone for two steps, then b2 catches up beside it: the frozen
    lane's rows (and ring) stay as they were."""

    def run(eng, dec):
        ta = int(_first(eng.prefill_and_sample("a2", PROMPTS["vb"], dec).token))
        tb = int(_first(eng.prefill_and_sample("b2", PROMPTS["vc"], dec).token))
        got_a, got_b = [ta], [tb]
        for _ in range(3):
            ta = int(_first(eng.decode_batch({"a2": (ta, dec)})[0]["a2"].token))
            got_a.append(ta)
        for _ in range(10):
            req = {"b2": (tb, dec)}
            if len(got_a) < 9:
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

    ref, port = engines
    assert run(port, DecodingParams(temperature=0.0)) == run(ref, RefDecoding(temperature=0.0))


def test_chunked_prefill_then_batched_decode_matches_the_reference(engines, case, family_dirs):
    """A 70-token prompt prefilled in 16-token chunks (the batched adapter's
    path; gpt_oss's ring wraps inside every chunk) then decoded on the
    batched slots: the reference's single-sequence greedy stream."""
    from dnet_tpu.core.engine import LocalEngine as RefEngine

    family, _, bits, _ = CASES[case]
    _, port = engines
    prompt = [(7 * i) % 250 + 1 for i in range(70)]
    ref = RefEngine(family_dirs[family], max_seq=MAX_SEQ * 2, param_dtype="float32", kv_quant_bits=bits)
    want = [r.token_id for r in ref.generate(prompt[:MAX_SEQ - 20], RefDecoding(), max_tokens=20, nonce="g")]
    dec = DecodingParams(temperature=0.0)
    port.reserve_slot("x")
    for i in range(0, MAX_SEQ - 20, 16):
        logits = port.prefill_chunk("x", prompt[i:min(i + 16, MAX_SEQ - 20)])
    toks = [int(_first(port.adopt_prefilled("x", logits, dec).token))]
    for _ in range(19):
        out, errs = port.decode_batch({"x": (toks[-1], dec)})
        assert not errs
        toks.append(int(_first(out["x"].token)))
    port.end_session("x")
    assert toks == want
