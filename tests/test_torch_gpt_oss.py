"""The port's gpt_oss against dnet_tpu's on the same tiny checkpoint
(tests/fakes/checkpoints.py make_tiny_gpt_oss: 4 layers alternating
sliding/full, head dim 16, a ring of W = 8, 4 experts top-2, sinks, YaRN).

Prefill logits within 2e-3 (tests/test_llama_parity.py:40), greedy streams
identical token for token, from a prompt longer than W so that both the
prefill and the decode wrap the ring, under moe_impl dense and dispatch
(capacity 1.25, with drops) and with int8 / int4 caches (the reference
under the same bits).  The ops the model adds (YaRN frequencies, the
sliding-window mask, the ring attention of a prompt chunk and of a decode
row) are held against the reference's own on the same numpy inputs.

The reference runs its Pallas kernels in interpret mode
(DNET_FLASH_INTERPRET=1), the path it takes on the TPU: its sliding layer's
decode then writes the ring first and attends it through the kernel, as
the port does.  Its dense CPU fallback attends the current token's key
unquantized instead, which an int4 cache turns into another greedy token.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu.core.engine import LocalEngine as RefEngine
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.api.inference import EngineCapabilityError
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.kvcache import KVConfig, cache_nbytes, init_cache, layer_slices
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.models import ModelConfig
from dnet_tpu_torch.models.convert import from_jax_params, hf_tensors
from dnet_tpu_torch.ops import attention, rope
from dnet_tpu_torch.utils.checkpoint import save_checkpoint
from dnet_tpu_torch.utils.random_init import GPT_OSS_20B_CONFIG, random_gpt_oss_params

pytestmark = pytest.mark.core

TOL = dict(atol=2e-3, rtol=2e-3)
MAX_SEQ = 64
# 26 tokens: the prompt alone wraps the W = 8 ring three times
PROMPT = [256] + list(b"The quick brown fox jumps")
N_TOKENS = 24


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNET_FLASH_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def gpt_oss_dir(tmp_path_factory):
    from tests.fakes.checkpoints import make_tiny_gpt_oss

    d = tmp_path_factory.mktemp("tiny_gpt_oss")
    make_tiny_gpt_oss(d)
    return d


def _pair(model_dir, impl="dense", bits=0):
    """(reference engine, port engine) with the same MoE path and cache."""
    ref = RefEngine(model_dir, max_seq=MAX_SEQ, param_dtype="float32", kv_quant_bits=bits)
    ref.model.moe_impl = impl
    port = LocalEngine(model_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", kv_quant_bits=bits)
    port.model.moe_impl = impl
    return ref, port


@pytest.fixture(scope="module")
def dense_pair(gpt_oss_dir):
    return _pair(gpt_oss_dir)


def _greedy(engine, decoding, n=N_TOKENS, prompt=PROMPT):
    return [r.token_id for r in engine.generate(prompt, decoding, max_tokens=n, nonce="g")]


def test_config_and_layout(dense_pair):
    _, port = dense_pair
    cfg = port.config
    assert (cfg.sliding_window, cfg.num_local_experts, cfg.num_experts_per_tok) == (8, 4, 2)
    assert port.model.pair_kinds == (1, 0)  # even layers slide, odd layers are full
    assert set(port.window_params) == {"a", "b"} and len(port.window_params["a"]) == 2
    kv = port.model.init_kv(4, 1, MAX_SEQ, "float32")
    assert kv["a"]["k"].shape == (2, 1, 8, 2, 16) and kv["b"]["k"].shape == (2, 1, MAX_SEQ, 2, 16)
    assert not port.model.kv_rewindable(MAX_SEQ) and port.model.kv_rewindable(8)


def test_prefill_logits_match(dense_pair):
    ref, port = dense_pair
    want = np.asarray(ref.prefill("p", PROMPT))
    np.testing.assert_allclose(port.prefill("p", PROMPT).numpy(), want, **TOL)
    # a second chunk continues the live session across the window
    more = list(b" over the lazy")
    np.testing.assert_allclose(port.prefill("p", more).numpy(), np.asarray(ref.prefill("p", more)), **TOL)
    ref.end_session("p")
    port.end_session("p")


def test_chunked_prefill_across_the_window(dense_pair):
    """The prompt in chunks of 5, 6 and 15 tokens (the second crosses the
    ring's wrap, the third is longer than W): each chunk's logits and the
    decode that follows as the reference's."""
    ref, port = dense_pair
    d, rd = DecodingParams(), RefDecoding()
    for a, b in ((0, 5), (5, 11), (11, 26)):
        np.testing.assert_allclose(port.prefill("c", PROMPT[a:b]).numpy(),
                                   np.asarray(ref.prefill("c", PROMPT[a:b])), **TOL)
    tok_p = tok_r = PROMPT[-1]
    got, want = [], []
    for _ in range(12):
        tok_p = int(port.decode_step("c", tok_p, d).token[0])
        tok_r = int(ref.decode_step("c", tok_r, rd).token[0])
        got.append(tok_p)
        want.append(tok_r)
    assert got == want
    ref.end_session("c")
    port.end_session("c")


def test_greedy_stream_wraps_the_ring(dense_pair):
    ref, port = dense_pair
    assert _greedy(port, DecodingParams()) == _greedy(ref, RefDecoding())


def test_greedy_stream_by_chunks(dense_pair):
    """Chunked decode (the serving path): the same tokens as the reference's
    single steps."""
    ref, port = dense_pair
    d = DecodingParams()
    toks = [int(port.prefill_and_sample("k", PROMPT, d).token[0])]
    port.decode_chunk_dispatch("k", toks[-1], d, 8)
    port.decode_chunk_dispatch("k", None, d, 8)
    for _ in range(2):
        toks += [int(r.token[0]) for r in port.decode_chunk_read("k")]
    port.end_session("k")
    assert toks == _greedy(ref, RefDecoding(), n=len(toks))


def test_dispatch_moe_stream(gpt_oss_dir):
    """Capacity dispatch at factor 1.25 (tokens over an expert's capacity
    are dropped, the prompt's bucket padding included): the same logits
    and stream as the reference's dispatch."""
    ref, port = _pair(gpt_oss_dir, impl="dispatch")
    assert port.model.moe_capacity_factor == ref.model.moe_capacity_factor == 1.25
    np.testing.assert_allclose(port.prefill("p", PROMPT).numpy(), np.asarray(ref.prefill("p", PROMPT)), **TOL)
    ref.end_session("p")
    port.end_session("p")
    assert _greedy(port, DecodingParams()) == _greedy(ref, RefDecoding())


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_cache_stream(gpt_oss_dir, bits):
    """DNET_KV_BITS 8 / 4: the ring and the full half both quantized; the
    stream equals the reference's under the same bits, and the engine
    counts the paired cache's bytes."""
    ref, port = _pair(gpt_oss_dir, bits=bits)
    np.testing.assert_allclose(port.prefill("p", PROMPT).numpy(), np.asarray(ref.prefill("p", PROMPT)), **TOL)
    ref.end_session("p")
    port.end_session("p")
    assert _greedy(port, DecodingParams()) == _greedy(ref, RefDecoding())
    cfg = port.model.kv_config
    assert port.kv_bytes == cache_nbytes(cfg(2, 1, 8, quant_bits=bits)) + cache_nbytes(cfg(2, 1, MAX_SEQ, quant_bits=bits))


def test_sliding_half_over_a_full_length_cache(gpt_oss_dir):
    """max_seq below the window: the sliding half keeps a max_seq-row cache
    (no ring) and attends through the sliding-window mask, as the
    reference does."""
    ref = RefEngine(gpt_oss_dir, max_seq=6, param_dtype="float32")
    port = LocalEngine(gpt_oss_dir, max_seq=6, param_dtype="float32", device="cpu")
    assert port.model.init_kv(4, 1, 6, "float32")["a"]["k"].shape[2] == 6
    prompt = PROMPT[:3]
    np.testing.assert_allclose(port.prefill("s", prompt).numpy(), np.asarray(ref.prefill("s", prompt)), **TOL)
    port.end_session("s")
    ref.end_session("s")
    assert _greedy(port, DecodingParams(), n=3, prompt=prompt) == _greedy(ref, RefDecoding(), n=3, prompt=prompt)


def test_kv_bytes_count_both_halves(dense_pair):
    _, port = dense_pair
    port.prefill("b", PROMPT[:3])
    port.end_session("b")
    # 2 sliding layers x 8 rows + 2 full layers x 64 rows, k and v, 2 KV heads x 16, f32
    assert port.kv_bytes == 2 * (2 * 8 + 2 * MAX_SEQ) * 2 * 16 * 4


def test_from_jax_params_gives_the_same_logits(dense_pair):
    """The reference's paired {"a", "b"} stacks carried across."""
    ref, port = dense_pair
    assert set(ref.window_params) == {"a", "b"}
    window, edge = from_jax_params(
        {h: {k: np.asarray(v) for k, v in half.items()} for h, half in ref.window_params.items()},
        {g: {k: np.asarray(a) for k, a in leaves.items()} for g, leaves in ref.edge_params.items()},
        port.config, "cpu",
    )
    torch.testing.assert_close(window[1]["wq"], port.window_params["b"][0]["wq"])
    carried = LocalEngine.from_params(port.config, window, edge, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    want = np.asarray(ref.prefill("j", PROMPT))
    ref.end_session("j")
    np.testing.assert_allclose(carried.prefill("j", PROMPT).numpy(), want, **TOL)


def test_synthetic_checkpoint_round_trip(tmp_path):
    """random gpt_oss params -> HF tensors -> checkpoint -> the loader reads
    the same weights back (experts untransposed) and the same logits."""
    cfg_dict = dict(GPT_OSS_20B_CONFIG, vocab_size=97, hidden_size=32, intermediate_size=24,
                    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                    num_local_experts=4, num_experts_per_tok=2, sliding_window=4,
                    layer_types=["sliding_attention", "full_attention"])
    cfg = ModelConfig.from_hf(cfg_dict)
    window, edge = random_gpt_oss_params(cfg, range(2), torch.device("cpu"), torch.float32, seed=3)
    save_checkpoint(tmp_path, cfg_dict, hf_tensors(window, edge))
    loaded = LocalEngine(tmp_path, max_seq=16, param_dtype="float32", device="cpu")
    torch.testing.assert_close(loaded.window_params["a"][0]["gate_up"], window[0]["gate_up"])
    torch.testing.assert_close(loaded.window_params["b"][0]["router_w"], window[1]["router_w"])
    direct = LocalEngine.from_params(cfg, window, edge, max_seq=16, param_dtype="float32", device="cpu")
    ids = [1, 2, 3, 4, 5, 6, 7]
    torch.testing.assert_close(loaded.prefill("a", ids), direct.prefill("a", ids))


def test_flat_layout_is_refused(gpt_oss_dir, tmp_path):
    """Layer kinds that do not pair into one sliding and one full half (an
    odd layer count here) are refused at load."""
    from tests.fakes.checkpoints import make_tiny_gpt_oss

    make_tiny_gpt_oss(tmp_path, {"num_hidden_layers": 3,
                                 "layer_types": ["sliding_attention", "full_attention", "sliding_attention"]})
    with pytest.raises(EngineCapabilityError, match="flat layout"):
        LocalEngine(tmp_path, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")


def test_unknown_moe_impl_fails_at_load(gpt_oss_dir, monkeypatch):
    monkeypatch.setenv("DNET_COMPUTE_MOE_IMPL", "desne")
    with pytest.raises(ValueError, match="unknown moe_impl"):
        LocalEngine(gpt_oss_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")


# ---- the ops the model adds -------------------------------------------------


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("head_dim,theta,factor,old_len", [(64, 150000.0, 32.0, 4096), (16, 150000.0, 32.0, 4096),
                                                            (128, 10000.0, 4.0, 2048)])
def test_yarn_frequencies_match(rng, truncate, head_dim, theta, factor, old_len):
    """YaRN with fractional (truncate false, gpt-oss) and integer ramp
    bounds: frequencies bit-equal, the same attention scaling, and the
    rotation within f32 rounding."""
    from dnet_tpu.ops import rope as ref_rope

    scaling = {"rope_type": "yarn", "factor": factor, "beta_fast": 32.0, "beta_slow": 1.0,
               "truncate": truncate, "original_max_position_embeddings": old_len}
    inv_ref, sc_ref = ref_rope.rope_frequencies(head_dim, theta, scaling, 131072)
    inv, sc = rope.rope_frequencies(head_dim, theta, scaling, 131072)
    np.testing.assert_array_equal(inv, inv_ref)
    assert sc == sc_ref and sc > 1.0
    x = rng.normal(size=(1, 5, 2, head_dim)).astype(np.float32)
    pos = 3000 + np.arange(5, dtype=np.int32)
    want = np.asarray(ref_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv_ref), sc_ref))
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(inv), sc).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_yarn_truncate_moves_the_ramp():
    scaling = dict(GPT_OSS_20B_CONFIG["rope_scaling"])
    fractional, _ = rope.rope_frequencies(64, 150000.0, scaling, 131072)
    integer, _ = rope.rope_frequencies(64, 150000.0, dict(scaling, truncate=True), 131072)
    assert not np.array_equal(fractional, integer)


def test_sliding_window_mask_matches():
    from dnet_tpu.ops.attention import sliding_window_mask as ref_mask

    for T, S, pos, window in ((5, 12, 4, 3), (1, 64, 40, 8), (9, 9, 0, 4)):
        np.testing.assert_array_equal(attention.sliding_window_mask(T, S, pos, window).numpy(),
                                      np.asarray(ref_mask(T, S, pos, window)))


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("T,t_real,pos", [(1, 1, 3), (1, 1, 21), (6, 6, 0), (6, 4, 13), (16, 11, 5), (20, 20, 30)])
def test_rotating_cached_attend_matches(rng, bits, T, t_real, pos):
    """A ring of W = 8 already holding positions [0, pos), then a chunk of T
    (t_real real): the attention output and the ring afterwards as the
    reference's (a decode row through the rotating kernel's plain version,
    a chunk through the dense attend over ring + chunk)."""
    from dnet_tpu.core.kvcache import KVConfig as RefKVConfig
    from dnet_tpu.core.kvcache import init_cache as ref_init_cache
    from dnet_tpu.core.kvcache import write_kv_rotating as ref_write
    from dnet_tpu.ops.attention import rotating_cached_attend as ref_attend

    W, window, H, KVH, Hd = 8, 8, 4, 2, 16
    ref = {n: a[0] for n, a in ref_init_cache(RefKVConfig(1, 1, W, KVH, Hd, dtype="float32", quant_bits=bits)).items()}
    port = layer_slices(init_cache(KVConfig(1, 1, W, KVH, Hd, dtype="float32", quant_bits=bits), torch.device("cpu")), 0)
    if pos:
        hist = rng.normal(size=(2, 1, pos, KVH, Hd)).astype(np.float32)
        ref = ref_write(ref, jnp.asarray(hist[0]), jnp.asarray(hist[1]), jnp.int32(0))
        from dnet_tpu_torch.core.kvcache import write_kv_rotating

        write_kv_rotating(port, torch.from_numpy(hist[0]), torch.from_numpy(hist[1]), 0)
    q = rng.normal(size=(1, T, H, Hd)).astype(np.float32)
    k = rng.normal(size=(1, T, KVH, Hd)).astype(np.float32)
    v = rng.normal(size=(1, T, KVH, Hd)).astype(np.float32)
    sinks = rng.normal(size=(H,)).astype(np.float32)
    want, ref = ref_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ref, jnp.int32(pos), window,
                           sinks=jnp.asarray(sinks), t_real=jnp.int32(t_real))
    got, port = attention.rotating_cached_attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                                 port, pos, window, sinks=torch.from_numpy(sinks), t_real=t_real)
    np.testing.assert_allclose(got.numpy()[:, :t_real], np.asarray(want)[:, :t_real], atol=2e-5, rtol=2e-5)
    for name in port:
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(ref[name]))
