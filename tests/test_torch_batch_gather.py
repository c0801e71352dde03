"""The port's dense-gather paged decode (core/batch.py `_dispatch_gather`,
kv/store.py `gather` / `scatter`) and the single-sequence paged ledger
(core/engine.py) against dnet_tpu's on the same weights.

The reference's BatchedEngine runs with DNET_KV_PAGED=1 and 8-token
blocks: its default paged mode (DNET_KV_RAGGED unset) at f32, a bf16 cache
under f32 params, int8 and packed int4, and its fallback when
DNET_KV_RAGGED=1 meets a quantized pool.  Greedy streams must be identical
token for token and logprobs within 2e-3 (the repo's parity tolerance),
through interleaved requests, R-step budget chunks and frozen inactive
lanes.  The pool ops and the paged prefix cache over an int8 pool are held
against the reference's op sequences on the same numpy rows, bit for bit;
the single-sequence ledger against the reference's LocalEngine under a
pool too small for every request.
"""

import json
import os

import numpy as np
import pytest
import torch

from dnet_tpu.config import reset_settings_cache
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.api.inference import BackpressureError, classify_result_error
from dnet_tpu_torch.core.batch import BatchedEngine
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.kv import BlockPool, BlockStore, KVPoolExhausted, PagedKVConfig, PagedPrefixCache
from dnet_tpu_torch.models import ModelConfig, get_ring_model_cls
from dnet_tpu_torch.models.convert import from_jax_params

pytestmark = pytest.mark.core

MAX_SEQ = 64
BT = 8
LP_TOL = 2e-3
PROMPTS = {
    "va": [256, 72, 101],
    "vb": [256, 84, 104, 105, 110, 3, 9, 12, 44, 7, 81],
    "vc": list(range(100, 118)),
}
# (KV dtype, quant bits, DNET_KV_RAGGED): the dense gather at every cache
# form, and the reference's fallback from the ragged kernel for a
# quantized pool
FORMS = {
    "f32": (None, 0, None),
    "bf16": ("bfloat16", 0, None),
    "q8": (None, 8, None),
    "q4": (None, 4, None),
    "q8_ragged_on": (None, 8, "1"),
}
ENV = {"DNET_KV_PAGED": "1", "DNET_KV_BLOCK_TOKENS": str(BT), "DNET_KV_RAGGED": None,
       "DNET_FLASH_INTERPRET": None, "DNET_KV_POOL_BLOCKS": None}


def _set_env(values):
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    reset_settings_cache()
    return saved


@pytest.fixture(scope="module", params=list(FORMS))
def form(request):
    saved = _set_env({**ENV, "DNET_KV_RAGGED": FORMS[request.param][2]})
    yield request.param
    _set_env(saved)


@pytest.fixture(scope="module")
def ref(tiny_llama_dir, form):
    from dnet_tpu.core.batch import BatchedEngine as RefBatched

    kv_dtype, bits, _ = FORMS[form]
    eng = RefBatched(tiny_llama_dir, slots=4, max_seq=MAX_SEQ, param_dtype="float32", kv_dtype=kv_dtype,
                     kv_quant_bits=bits)
    assert eng.kv_pool is not None and eng.kv_ragged is False  # the dense gather
    return eng


def _weights(model_dir, ref_eng):
    cfg = ModelConfig.from_hf(json.loads((model_dir / "config.json").read_text()))
    return (cfg,) + from_jax_params(
        {k: np.asarray(v) for k, v in ref_eng.window_params.items()},
        {g: {k: np.asarray(a) for k, a in leaves.items()} for g, leaves in ref_eng.edge_params.items()},
        cfg, "cpu",
    )


@pytest.fixture(scope="module")
def port(tiny_llama_dir, ref, form):
    cfg, window, edge = _weights(tiny_llama_dir, ref.eng)
    kv_dtype, bits, _ = FORMS[form]
    return BatchedEngine.from_params(cfg, window, edge, slots=4, max_seq=MAX_SEQ, param_dtype="float32",
                                     device="cpu", kv_dtype=kv_dtype, kv_quant_bits=bits)


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


def test_gather_mode_and_its_pool(port, form):
    kv_dtype, bits, _ = FORMS[form]
    stats = port.stats()
    assert stats["kv_mode"] == "paged" and stats["kv_ragged"] is False and port.kv is None
    assert stats["kv_quant_bits"] == bits and ("k_scale" in port.kv_store.kv) == bool(bits)
    want = {0: getattr(torch, kv_dtype or "float32"), 8: torch.int8, 4: torch.uint8}[bits]
    assert port.kv_store.kv["k"].dtype == want
    if bits:
        assert port.kv_store.kv["k_scale"].shape == port.kv_store.kv["k"].shape[:-1] + (1,)


def test_interleaved_requests_match_the_reference(port, ref):
    want = _interleaved(ref, RefDecoding(temperature=0.0, logprobs=True, top_logprobs=3), steps=20)
    got = _interleaved(port, DecodingParams(temperature=0.0, logprobs=True, top_logprobs=3), steps=20)
    _assert_streams_match(got, want)
    assert not port.slot_of and port.kv_pool.used == 0
    port.kv_pool.check_conservation()


def test_budget_chunks_match_the_reference_and_serial_steps(port, ref, monkeypatch):
    """R-step chunks (a max_seq-wide gather, 16/8/4/2 steps, extras
    buffered) give the serial stream; the reference's fused chunks give the
    same tokens."""
    want = _interleaved(ref, RefDecoding(temperature=0.0, logprobs=True), steps=12, budgets=True)
    dec = DecodingParams(temperature=0.0, logprobs=True)
    widths = []
    dispatch = port._dispatch_gather

    def counted(order, lanes, active, R, *rest):
        widths.append(R)
        return dispatch(order, lanes, active, R, *rest)

    monkeypatch.setattr(port, "_dispatch_gather", counted)
    got = _interleaved(port, dec, steps=12, budgets=True)
    assert widths == [8, 2, 1]
    _assert_streams_match(got, want)
    widths.clear()
    _assert_streams_match(_interleaved(port, dec, steps=12), got)
    assert widths == [1] * 11


def test_partial_batch_freezes_inactive_lanes(port, ref):
    """A lane that skips steps neither moves nor corrupts its blocks: a2
    runs alone for two steps, then b2 catches up beside it."""

    def run(eng, dec):
        for n in ("a2", "b2"):
            eng.end_session(n)
        ta = int(_first(eng.prefill_and_sample("a2", PROMPTS["vb"], dec).token))
        tb = int(_first(eng.prefill_and_sample("b2", PROMPTS["vc"], dec).token))
        got_a, got_b = [ta], [tb]
        for _ in range(2):
            ta = int(_first(eng.decode_batch({"a2": (ta, dec)})[0]["a2"].token))
            got_a.append(ta)
        for _ in range(8):
            req = {"b2": (tb, dec)}
            if len(got_a) < 7:
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


def test_scatter_writes_only_the_active_lanes_blocks(port, monkeypatch):
    """A single step's gather is the pow2 bucket of the widest active
    table, and its scatter lists each active lane's current block once."""
    dec = DecodingParams(temperature=0.0)
    toks = {n: int(_first(port.prefill_and_sample(n, PROMPTS[n], dec).token)) for n in ("va", "vc")}
    seen = []
    gather, scatter = port.kv_store.gather, port.kv_store.scatter
    monkeypatch.setattr(port.kv_store, "gather", lambda ids: seen.append(ids.shape) or gather(ids))
    monkeypatch.setattr(port.kv_store, "scatter", lambda view, triples: seen.append(list(triples))
                        or scatter(view, triples))
    out, errs = port.decode_batch({"va": (toks["va"], dec)})
    assert not errs
    slot = port.slot_of["va"]
    assert seen == [(4, 1), [(slot, 0, port._tables[slot].blocks[0])]]
    for n in ("va", "vc"):
        port.end_session(n)


# ---- the pool ops and the prefix cache over a quantized pool ------------


def _pool_pair(tiny_llama_dir, bits, blocks=12):
    """The reference's and the port's BlockStore of the tiny llama's
    layout, int8 or packed int4 with scales."""
    from dnet_tpu.kv import BlockStore as RefStore
    from dnet_tpu.kv import PagedKVConfig as RefCfg
    from dnet_tpu.models import ModelConfig as RefModelConfig
    from dnet_tpu.models import get_ring_model_cls as ref_cls

    raw = json.loads((tiny_llama_dir / "config.json").read_text())
    L = raw["num_hidden_layers"]
    rm = ref_cls("llama")(RefModelConfig.from_hf(raw), range(L))
    pm = get_ring_model_cls("llama")(ModelConfig.from_hf(raw), range(L), "cpu")
    rs = RefStore(rm, L, RefCfg(block_tokens=BT, pool_blocks=blocks), "float32", quant_bits=bits,
                  session_tokens=MAX_SEQ)
    ps = BlockStore(pm, L, PagedKVConfig(block_tokens=BT, pool_blocks=blocks), "float32", quant_bits=bits,
                    session_tokens=MAX_SEQ)
    return rs, ps


def _random_like(tree, seed):
    """Numpy leaves of the reference tree's shapes and dtypes: codes over
    their whole range, positive scales."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, leaf in tree.items():
        dt = np.dtype(leaf.dtype.name if hasattr(leaf.dtype, "name") else leaf.dtype)
        if dt.kind in "iu":
            info = np.iinfo(dt)
            out[name] = rng.integers(info.min, info.max, size=leaf.shape, endpoint=True).astype(dt)
        else:
            out[name] = rng.uniform(0.01, 2.0, size=leaf.shape).astype(dt)
    return out


def _assert_trees_equal(port_tree, ref_tree):
    assert set(port_tree) == set(ref_tree)
    for name, a in port_tree.items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(ref_tree[name]), err_msg=name)


@pytest.mark.parametrize("bits", [8, 4])
def test_gather_and_scatter_match_the_reference_ops(tiny_llama_dir, bits):
    """commit_row, gather at a bucketed width and at the full width, and a
    scatter of a few (slot, block, phys) triples of a modified view, on the
    same numpy codes and scales: the pools stay equal bit for bit."""
    import jax.numpy as jnp

    rs, ps = _pool_pair(tiny_llama_dir, bits)
    row = _random_like({n: np.asarray(a)[:, :1].repeat(MAX_SEQ // BT, 1).reshape(
        a.shape[0], 1, MAX_SEQ, *a.shape[3:]) for n, a in rs.kv.items()}, 1)
    for store, wrap in ((rs, jnp.asarray), (ps, torch.from_numpy)):
        store.commit_row({n: wrap(a) for n, a in row.items()}, [0, 1, 2, 5], [7, 2, 9, 0])
    _assert_trees_equal(ps.kv, rs.kv)
    ids = np.array([[7, 2, 9, 0], [0, 0, 0, 0], [2, 9, 0, 0]], dtype=np.int32)
    view_r, view_p = rs.gather(ids), ps.gather(ids)
    _assert_trees_equal(view_p, view_r)
    assert view_p["k"].shape[1:3] == (3, 4 * BT)
    full = np.zeros((2, MAX_SEQ // BT), dtype=np.int32)
    full[0, :3] = [9, 7, 2]
    _assert_trees_equal(ps.gather(full), rs.gather(full))
    fresh = _random_like({n: np.asarray(a) for n, a in view_r.items()}, 2)
    triples = [(0, 3, 4), (2, 1, 11), (1, 0, 5)]
    rs.scatter({n: jnp.asarray(a) for n, a in fresh.items()}, triples)
    ps.scatter({n: torch.from_numpy(a) for n, a in fresh.items()}, triples)
    _assert_trees_equal(ps.kv, rs.kv)
    with pytest.raises(ValueError, match="more than once"):
        ps.scatter({n: torch.from_numpy(a) for n, a in fresh.items()}, [(0, 0, 3), (1, 0, 3)])
    with pytest.raises(ValueError, match="outside"):
        ps.scatter({n: torch.from_numpy(a) for n, a in fresh.items()}, [(0, 4, 3)])
    with pytest.raises(ValueError, match="outside"):
        ps.gather(np.array([[12]]))


def test_rotating_session_layout_is_refused_like_the_reference(tmp_path):
    """gpt_oss's W-row rings cannot be addressed by blocks: both stores
    raise NotImplementedError (the engines then serve dense slots)."""
    from dnet_tpu.kv import BlockStore as RefStore
    from dnet_tpu.kv import PagedKVConfig as RefCfg
    from dnet_tpu.models import ModelConfig as RefModelConfig
    from dnet_tpu.models import get_ring_model_cls as ref_cls
    from tests.fakes.checkpoints import make_tiny_gpt_oss

    raw = make_tiny_gpt_oss(tmp_path)
    L = raw["num_hidden_layers"]
    rm = ref_cls("gpt_oss")(RefModelConfig.from_hf(raw), range(L))
    pm = get_ring_model_cls("gpt_oss")(ModelConfig.from_hf(raw), range(L), "cpu")
    with pytest.raises(NotImplementedError, match="rotating"):
        RefStore(rm, L, RefCfg(block_tokens=BT, pool_blocks=8), "float32", session_tokens=MAX_SEQ)
    with pytest.raises(NotImplementedError, match="rotating"):
        BlockStore(pm, L, PagedKVConfig(block_tokens=BT, pool_blocks=8), "float32", session_tokens=MAX_SEQ)


def test_prefix_cache_over_a_q8_pool_matches_the_reference(tiny_llama_dir):
    """Store, dedup against the parent, a hit that aliases full blocks and
    retains the partial tail: equal blocks and refcounts, and the hit's
    gathered row (codes and scales) equal to the reference's."""
    import jax.numpy as jnp

    from dnet_tpu.kv import BlockPool as RefPool
    from dnet_tpu.kv import PagedKVConfig as RefCfg
    from dnet_tpu.kv import PagedPrefixCache as RefCache

    rs, ps = _pool_pair(tiny_llama_dir, 8, blocks=16)
    rp, pp = RefPool(RefCfg(block_tokens=BT, pool_blocks=16)), BlockPool(PagedKVConfig(BT, 16))
    rc = RefCache(rp, rs, 4, min_tokens=4, row_tokens=MAX_SEQ)
    pc = PagedPrefixCache(pp, ps, 4, min_tokens=4)
    shapes = {n: np.asarray(a)[:, :1].repeat(MAX_SEQ // BT, 1).reshape(a.shape[0], 1, MAX_SEQ, *a.shape[3:])
              for n, a in rs.kv.items()}
    base = list(range(100, 120))  # 2 full blocks + 4 tokens
    for seed, ids in ((1, base), (2, base + [5, 6, 7, 8, 9, 10, 11])):
        row = _random_like(shapes, seed)
        rc.store(ids, {n: jnp.asarray(a) for n, a in row.items()})
        pc.store(ids, {n: torch.from_numpy(a) for n, a in row.items()})
        assert pp.used == rp.used and all(pp.refcount(b) == rp.refcount(b) for b in range(16))
    _assert_trees_equal(ps.kv, rs.kv)
    want = rc.lookup_blocks(base + [1, 2])
    got = pc.lookup_blocks(base + [1, 2])
    assert got == want and got[0] == 20 and got[2] == 2
    row_r, row_p = rs.gather_row(want[1], MAX_SEQ), ps.gather_row(got[1], MAX_SEQ)
    for name in row_p:
        np.testing.assert_array_equal(row_p[name][:, :, :20].numpy(), np.asarray(row_r[name])[:, :, :20])
    for pool, blocks in ((rp, want[1]), (pp, got[1])):
        pool.free_blocks(blocks)
    rc.clear()
    pc.clear()
    assert pp.used == rp.used == 0


# ---- the single-sequence paged ledger ------------------------------------


@pytest.fixture
def ledger_env(monkeypatch):
    def apply(**env):
        for k, v in {**ENV, **env}.items():
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        reset_settings_cache()

    yield apply
    reset_settings_cache()


def test_single_sequence_ledger_matches_the_reference(tiny_llama_dir, ledger_env):
    """A pool of 3 blocks: a 20-token prompt takes all 3 (and its decode
    stays inside them); a second prompt is refused before any compute, and
    leaves no session; decoding past 24 tokens is refused; ending the
    session returns every block.  Tokens equal the reference's and the
    ledger-free engine's."""
    from dnet_tpu.core.engine import LocalEngine as RefEngine
    from dnet_tpu.kv import KVPoolExhausted as RefExhausted

    ledger_env(DNET_KV_POOL_BLOCKS="3")
    ref = RefEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32")
    port = LocalEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    plain = LocalEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", kv_paged=False)
    assert port.kv_pool is not None and plain.kv_pool is None and ref.kv_pool is not None

    def run(eng, dec, exhausted):
        toks = [int(_first(eng.prefill_and_sample("big", list(range(100, 120)), dec).token))]
        with pytest.raises(exhausted, match="paged KV pool exhausted"):
            eng.prefill_and_sample("late", [256, 65], dec)
        assert "late" not in eng.sessions
        for _ in range(4):  # positions 20..23 stay inside block 3
            toks.append(int(_first(eng.decode_step("big", toks[-1], dec).token)))
        with pytest.raises(exhausted, match="paged KV pool exhausted"):
            eng.decode_step("big", toks[-1], dec)
        assert eng.kv_pool.used == 3
        eng.end_session("big")
        assert eng.kv_pool.used == 0
        return toks

    want = run(ref, RefDecoding(temperature=0.0), RefExhausted)
    got = run(port, DecodingParams(temperature=0.0), KVPoolExhausted)
    assert got == want
    assert isinstance(classify_result_error(str(KVPoolExhausted(1, 0, 3))), BackpressureError)
    stream = [r.token_id for r in plain.generate(list(range(100, 120)), DecodingParams(), max_tokens=5, nonce="p")]
    assert stream == want


def test_ledger_debits_chunks_and_the_sweep_releases(tiny_llama_dir, ledger_env):
    """A decode chunk debits its blocks up front; a chunk the pool cannot
    cover falls back to single steps; the TTL sweep returns an abandoned
    session's blocks."""
    ledger_env(DNET_KV_POOL_BLOCKS="4")
    eng = LocalEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    dec = DecodingParams(temperature=0.0)
    tok = int(_first(eng.prefill_and_sample("s", list(range(100, 110)), dec).token))
    assert eng.kv_pool.used == 2
    assert eng.decode_chunk_dispatch("s", tok, dec, 16) == 16  # 10 + 16 = 26 tokens: 4 blocks
    assert eng.kv_pool.used == 4
    eng.decode_chunk_read("s")
    assert eng.decode_chunk_dispatch("s", None, dec, 16) == 0  # 42 tokens do not fit
    eng.sessions["s"].last_used -= 2 * eng.KV_TTL_S
    assert eng.sweep_sessions() == 1 and eng.kv_pool.used == 0
    eng.kv_pool.check_conservation()


def test_ledger_off_for_a_block_size_that_does_not_divide_max_seq(tiny_llama_dir, ledger_env):
    ledger_env(DNET_KV_BLOCK_TOKENS="24")
    eng = LocalEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    assert eng.kv_pool is None and "kv_mode" not in eng.stats()
