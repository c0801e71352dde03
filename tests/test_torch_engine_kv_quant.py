"""The port's LocalEngine with a quantized KV cache (kv_quant_bits 8 / 4)
against dnet_tpu's on the same tiny checkpoint.

Prefill logits (a first chunk and a continuation, whose prefill reads the
dequantized live prefix) within 2e-3 (tests/test_llama_parity.py:40);
greedy streams identical token for token, by single steps and by chunked
decode (the quantized decode's plain version on the CPU).
"""

import numpy as np
import pytest
import torch

from dnet_tpu.core.engine import LocalEngine as RefEngine
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.kvcache import cache_nbytes
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.models import llama
from dnet_tpu_torch.ops import flash_attention

pytestmark = pytest.mark.core

TOL = dict(atol=2e-3, rtol=2e-3)
MAX_SEQ = 64
PROMPT = [256] + list(b"The quick brown fox")


@pytest.fixture(scope="module", params=[8, 4])
def bits(request):
    return request.param


@pytest.fixture(scope="module")
def ref_engine(tiny_llama_dir, bits):
    return RefEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", kv_quant_bits=bits)


@pytest.fixture(scope="module")
def engine(tiny_llama_dir, bits):
    return LocalEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", kv_quant_bits=bits)


def test_session_cache_is_quantized(engine, bits):
    sess = engine.new_session("c")
    assert sorted(sess.kv) == ["k", "k_scale", "v", "v_scale"]
    cfg = engine.model.kv_config(len(engine.model.layers), 1, MAX_SEQ, engine.kv_dtype, bits)
    assert engine.stats() == {"kv_dtype": "float32", "kv_quant_bits": bits, "kv_bytes": cache_nbytes(cfg),
                              "weight_policy": "fit", **engine.weight_stats()}
    assert engine.weight_stats()["weight_quant_bits"] == 0
    engine.end_session("c")


def test_prefill_logits_match(engine, ref_engine):
    want = np.asarray(ref_engine.prefill("p", PROMPT))
    np.testing.assert_allclose(engine.prefill("p", PROMPT).numpy(), want, **TOL)
    # a second chunk reads the first one's quantized prefix
    want2 = np.asarray(ref_engine.prefill("p", [101, 102, 103]))
    np.testing.assert_allclose(engine.prefill("p", [101, 102, 103]).numpy(), want2, **TOL)
    engine.end_session("p")
    ref_engine.end_session("p")


def _ref_greedy(ref_engine, n):
    return [r.token_id for r in ref_engine.generate(PROMPT, RefDecoding(), max_tokens=n, nonce="g")]


def test_greedy_stream_by_single_steps(engine, ref_engine):
    got = [r.token_id for r in engine.generate(PROMPT, DecodingParams(), max_tokens=16, nonce="g")]
    assert got == _ref_greedy(ref_engine, 16)


def test_greedy_stream_by_chunks(engine, ref_engine):
    d = DecodingParams()
    toks = [int(engine.prefill_and_sample("c", PROMPT, d).token[0])]
    engine.decode_chunk_dispatch("c", toks[-1], d, 8)
    engine.decode_chunk_dispatch("c", None, d, 4)
    for _ in range(2):
        toks += [int(r.token[0]) for r in engine.decode_chunk_read("c")]
    toks += [int(r.token[0]) for r in engine.decode_chunk("c", toks[-1], d, 3)]
    toks.append(int(engine.decode_step("c", toks[-1], d).token[0]))
    engine.end_session("c")
    assert len(toks) == 16 and toks == _ref_greedy(ref_engine, 16)


def test_bf16_cache_under_f32_params(tiny_llama_dir):
    """kv_dtype="bfloat16" (DNET_KV_BITS=16) keeps a bf16 cache under f32
    params, as the reference's kv_dtype does."""
    eng = LocalEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", kv_dtype="bfloat16")
    ref = RefEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", kv_dtype="bfloat16")
    assert str(eng.new_session("b").kv["k"].dtype) == "torch.bfloat16"
    eng.end_session("b")
    got = [r.token_id for r in eng.generate(PROMPT, DecodingParams(), max_tokens=12, nonce="g")]
    assert got == [r.token_id for r in ref.generate(PROMPT, RefDecoding(), max_tokens=12, nonce="g")]


@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_prefill_over_a_cache_in_another_dtype_runs_in_f32(monkeypatch, q_dtype, kv_dtype):
    """The prefill kernel takes one dtype: a bf16 cache under an f32 q
    (DNET_KV_BITS=16) reaches it as the live prefix and q upcast to f32
    (exact), never mixed, whatever the plain version would take."""
    seen = []
    real = flash_attention.flash_prefill

    def spy(q, k, v, pos, **kw):
        seen.append((q.dtype, k.dtype, v.dtype, k.shape[1]))
        return real(q, k, v, pos, **kw)

    monkeypatch.setattr(flash_attention, "flash_prefill", spy)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 5, 4, 16, generator=g).to(q_dtype)
    k, v = (torch.randn(1, 32, 2, 16, generator=g).to(kv_dtype) for _ in range(2))
    out = flash_attention.flash_attend_causal(q, k, v, 7)
    assert seen == [(torch.float32, torch.float32, torch.float32, 12)]
    want = flash_attention.flash_prefill_plain(q.float(), k.float(), v.float(), 7).to(q_dtype)
    assert out.dtype == q_dtype
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)


def test_decode_lengths_made_once_per_step(tiny_llama_dir, monkeypatch):
    """A decode step builds its lengths vector once for all layers, by
    single steps and in a chunk; a prefill builds none."""
    calls = []
    real = llama.decode_lengths
    monkeypatch.setattr(llama, "decode_lengths", lambda *a: calls.append(a) or real(*a))
    eng = LocalEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", kv_quant_bits=8)
    assert len(eng.model.layers) > 1
    eng.prefill("n", PROMPT)
    assert calls == []
    eng.decode_step("n", 65, DecodingParams())
    assert [c[1] for c in calls] == [len(PROMPT)]
    K = eng.decode_chunk_dispatch("n", 66, DecodingParams(), 4)
    assert K == 4 and [c[1] for c in calls[1:]] == [len(PROMPT) + 1 + i for i in range(K)]


def test_unsupported_quant_bits_raise(tiny_llama_dir):
    with pytest.raises(ValueError, match="kv_quant_bits"):
        LocalEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", kv_quant_bits=16)
