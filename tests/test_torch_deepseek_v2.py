"""The port's deepseek_v2 against dnet_tpu's on the same tiny checkpoints
(tests/fakes/checkpoints.py make_tiny_deepseek_v2: 4 layers, layer 0 dense
and 3 MoE, 4 heads, MLA with q/k head dim 24 = nope 16 + rope 8 and v head
dim 12, 4 routed experts top-2 + 1 shared).

Cases: V2-Lite's layout (no q LoRA, greedy routing), q LoRA of rank 24,
group-limited routing (2 groups, the best 1 kept), and YaRN factor 40 with
mscale = mscale_all_dim = 0.707 (the softmax scale takes mscale^2, which
transformers drops, so this case is held against dnet_tpu only).  Each case
holds prefill logits within 2e-3 (tests/test_llama_parity.py:40) and
identical greedy streams, under moe_impl dense and dispatch (capacity 1.25,
with drops) and with int8 / int4 caches.  `from_jax_params` carries the
reference's {"dense", "moe"} segments across, and `hf_tensors` writes a
checkpoint the loader reads back.  The ops the model adds (the interleaved
RoPE, the SwiGLU expert closures, the asymmetric cache) are held against the
reference's on the same numpy inputs, f32 within 2e-5.  The lite and q LoRA
cases are also held against transformers, as tests/test_deepseek_v2_parity.py
holds the reference (3e-3, 8 greedy tokens).

The reference runs its Pallas kernels in interpret mode
(DNET_FLASH_INTERPRET=1), at qk 24 / v 12, the path it takes on the TPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu.core.engine import LocalEngine as RefEngine
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.kvcache import KVConfig, cache_nbytes, init_cache, layer_slices, read_kv, write_kv
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.models import ModelConfig
from dnet_tpu_torch.models.convert import from_jax_params, hf_tensors
from dnet_tpu_torch.ops import moe, rope
from dnet_tpu_torch.utils.checkpoint import save_checkpoint
from dnet_tpu_torch.utils.random_init import DEEPSEEK_V2_LITE_CONFIG, random_deepseek_v2_params

pytestmark = pytest.mark.core

TOL = dict(atol=2e-3, rtol=2e-3)
OP_TOL = dict(atol=2e-5, rtol=2e-5)
MAX_SEQ = 96
PROMPT = [256] + list(b"The quick brown fox jumps over")
N_TOKENS = 24
CASES = {
    "lite": {},
    "q_lora": {"q_lora_rank": 24},
    "group_limited": {"topk_method": "group_limited_greedy", "n_group": 2, "topk_group": 1},
    "yarn": {"rope_scaling": {"type": "yarn", "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
                              "original_max_position_embeddings": 64}},
}


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNET_FLASH_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def case_dirs(tmp_path_factory):
    from tests.fakes.checkpoints import make_tiny_deepseek_v2

    dirs = {}
    for name, overrides in CASES.items():
        d = tmp_path_factory.mktemp(f"tiny_deepseek_{name}")
        make_tiny_deepseek_v2(d, overrides)
        dirs[name] = d
    return dirs


def _pair(model_dir, impl="dense", bits=0):
    """(reference engine, port engine) with the same MoE path and cache."""
    ref = RefEngine(model_dir, max_seq=MAX_SEQ, param_dtype="float32", kv_quant_bits=bits)
    ref.model.moe_impl = impl
    port = LocalEngine(model_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", kv_quant_bits=bits)
    port.model.moe_impl = impl
    return ref, port


@pytest.fixture(scope="module")
def pairs(case_dirs):
    return {name: _pair(d) for name, d in case_dirs.items()}


def _greedy(engine, decoding, n=N_TOKENS, prompt=PROMPT):
    return [r.token_id for r in engine.generate(prompt, decoding, max_tokens=n, nonce="g")]


def _held(ref, port, prompt=PROMPT, n=N_TOKENS):
    """Prefill logits within 2e-3, then identical greedy streams."""
    want = np.asarray(ref.prefill("p", prompt))
    np.testing.assert_allclose(port.prefill("p", prompt).numpy(), want, **TOL)
    ref.end_session("p")
    port.end_session("p")
    assert _greedy(port, DecodingParams(), n, prompt) == _greedy(ref, RefDecoding(), n, prompt)


def test_config_and_layout(pairs):
    ref, port = pairs["lite"]
    m = port.model
    assert (m.qk_head_dim, m.v_head_dim, m.kv_lora_rank, m.q_lora_rank) == (24, 12, 24, None)
    assert set(port.window_params) == {"dense", "moe"}
    assert [len(port.window_params[s]) for s in ("dense", "moe")] == [1, 3]
    assert "w_gate" in port.window_params["dense"][0] and port.window_params["moe"][0]["e_gate"].shape == (4, 64, 32)
    kv = m.init_kv(4, 1, MAX_SEQ, "float32")
    assert kv["k"].shape == (4, 1, MAX_SEQ, 4, 24) and kv["v"].shape == (4, 1, MAX_SEQ, 4, 12)
    assert m.softmax_scale == ref.model.softmax_scale == 24**-0.5


def test_yarn_softmax_scale_takes_mscale_squared(pairs):
    ref, port = pairs["yarn"]
    mscale = 0.1 * 0.707 * np.log(40) + 1.0
    assert port.model.softmax_scale == pytest.approx(24**-0.5 * mscale**2, rel=1e-12)
    assert port.model.softmax_scale == ref.model.softmax_scale
    assert port.model.rope_scale == ref.model.rope_scale
    np.testing.assert_array_equal(port.model.inv_freq.numpy(), np.asarray(ref.model.inv_freq))


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_greedy_stream_match(pairs, case):
    ref, port = pairs[case]
    _held(ref, port)


@pytest.mark.parametrize("case", ["lite", "q_lora"])
def test_matches_transformers(case_dirs, pairs, case):
    """The same checkpoints through transformers' DeepseekV2ForCausalLM
    (eager attention, f32), as tests/test_deepseek_v2_parity.py holds the
    reference: the last position's logits within its 3e-3 and 8 equal
    greedy tokens.  (Not the YaRN case: transformers drops the mscale^2.)"""
    from transformers import DeepseekV2ForCausalLM

    hf = DeepseekV2ForCausalLM.from_pretrained(case_dirs[case], dtype=torch.float32,
                                               attn_implementation="eager").eval()
    _, port = pairs[case]
    ids = [256, 72, 101, 108, 108, 111]
    with torch.no_grad():
        want = hf(torch.tensor([ids])).logits[0, -1].numpy()
        hf_out = hf.generate(torch.tensor([ids]), max_new_tokens=8, do_sample=False, temperature=None, top_p=None,
                             top_k=None, pad_token_id=0)[0, len(ids):].tolist()
    got = port.prefill("t", ids)[0].numpy()
    port.end_session("t")
    np.testing.assert_allclose(got, want, atol=3e-3, rtol=3e-3)
    assert _greedy(port, DecodingParams(), 8, ids) == hf_out


def test_chunked_prefill_and_decode_chunks(pairs):
    """The prompt in chunks of 7 and 24 tokens (a live session continued),
    then the serving path's chunked decode: the reference's tokens."""
    ref, port = pairs["lite"]
    for a, b in ((0, 7), (7, len(PROMPT))):
        np.testing.assert_allclose(port.prefill("c", PROMPT[a:b]).numpy(),
                                   np.asarray(ref.prefill("c", PROMPT[a:b])), **TOL)
    ref.end_session("c")
    port.end_session("c")
    d = DecodingParams()
    toks = [int(port.prefill_and_sample("k", PROMPT, d).token[0])]
    port.decode_chunk_dispatch("k", toks[-1], d, 8)
    port.decode_chunk_dispatch("k", None, d, 8)
    for _ in range(2):
        toks += [int(r.token[0]) for r in port.decode_chunk_read("k")]
    port.end_session("k")
    assert toks == _greedy(ref, RefDecoding(), n=len(toks))


@pytest.mark.parametrize("case,impl", [("lite", "dispatch"), ("group_limited", "dispatch"), ("lite", "auto")])
def test_dispatch_moe_stream(case_dirs, case, impl):
    """Capacity dispatch at factor 1.25 (the prompt's bucket padding
    overflows experts, so tokens are dropped), and "auto" (dispatch for the
    prompt, dense for decode rows): the reference's logits and stream
    under the same path."""
    ref, port = _pair(case_dirs[case], impl=impl)
    assert port.model.moe_capacity_factor == ref.model.moe_capacity_factor == 1.25
    _held(ref, port)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ["lite", "q_lora"])
def test_quantized_cache_stream(case_dirs, case, bits):
    """DNET_KV_BITS 8 / 4 over the asymmetric cache (int4: K packs 12 bytes
    a row, V 6): the reference's stream under the same bits, and the
    engine counts the cache's bytes."""
    ref, port = _pair(case_dirs[case], bits=bits)
    _held(ref, port)
    assert port.kv_bytes == cache_nbytes(port.model.kv_config(4, 1, MAX_SEQ, quant_bits=bits))


def test_bf16_params_track_f32(case_dirs):
    """bf16 params (the served dtype) stay near the f32 logits."""
    f32 = LocalEngine(case_dirs["lite"], max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    bf16 = LocalEngine(case_dirs["lite"], max_seq=MAX_SEQ, param_dtype="bfloat16", device="cpu")
    a = f32.prefill("p", PROMPT)
    b = bf16.prefill("p", PROMPT).float()
    assert b.shape == a.shape and bool(torch.isfinite(b).all())
    assert (a - b).abs().max().item() < 0.05


def test_kv_bytes_are_the_asymmetric_cache(pairs):
    _, port = pairs["lite"]
    port.prefill("b", PROMPT[:3])
    port.end_session("b")
    # 4 layers x 96 slots x 4 KV heads x (24 + 12), f32
    assert port.kv_bytes == 4 * MAX_SEQ * 4 * (24 + 12) * 4


@pytest.mark.parametrize("case", ["lite", "q_lora"])
def test_from_jax_params_gives_the_same_logits(pairs, case):
    """The reference's {"dense", "moe"} segments carried across."""
    ref, port = pairs[case]
    assert set(ref.window_params) == {"dense", "moe"}
    window, edge = from_jax_params(
        {s: {k: np.asarray(v) for k, v in seg.items()} for s, seg in ref.window_params.items()},
        {g: {k: np.asarray(a) for k, a in leaves.items()} for g, leaves in ref.edge_params.items()},
        port.config, "cpu",
    )
    torch.testing.assert_close(window[2]["e_down"], port.window_params["moe"][1]["e_down"])
    carried = LocalEngine.from_params(port.config, window, edge, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    want = np.asarray(ref.prefill("j", PROMPT))
    ref.end_session("j")
    np.testing.assert_allclose(carried.prefill("j", PROMPT).numpy(), want, **TOL)


@pytest.mark.parametrize("q_lora_rank", [None, 16])
def test_synthetic_checkpoint_round_trip(tmp_path, q_lora_rank):
    """random deepseek_v2 params -> HF tensors (per-expert names) ->
    checkpoint -> the loader reads the same weights back and the same
    logits."""
    cfg_dict = dict(DEEPSEEK_V2_LITE_CONFIG, vocab_size=97, hidden_size=32, intermediate_size=48,
                    moe_intermediate_size=16, num_hidden_layers=3, num_attention_heads=2, num_key_value_heads=2,
                    q_lora_rank=q_lora_rank, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
                    v_head_dim=8, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2)
    cfg = ModelConfig.from_hf(cfg_dict)
    window, edge = random_deepseek_v2_params(cfg, range(3), torch.device("cpu"), torch.float32, seed=3)
    tensors = hf_tensors(window, edge)
    assert "model.layers.1.mlp.experts.3.down_proj.weight" in tensors
    assert ("model.layers.0.self_attn.q_proj.weight" in tensors) == (q_lora_rank is None)
    save_checkpoint(tmp_path, cfg_dict, tensors)
    loaded = LocalEngine(tmp_path, max_seq=16, param_dtype="float32", device="cpu")
    torch.testing.assert_close(loaded.window_params["moe"][0]["e_up"], window[1]["e_up"])
    torch.testing.assert_close(loaded.window_params["dense"][0]["wkv_b"], window[0]["wkv_b"])
    direct = LocalEngine.from_params(cfg, window, edge, max_seq=16, param_dtype="float32", device="cpu")
    ids = [1, 2, 3, 4, 5, 6, 7]
    torch.testing.assert_close(loaded.prefill("a", ids), direct.prefill("a", ids))


def test_lite_config_widths():
    """DeepSeek-V2-Lite-Chat's published widths, as the chip's full-width
    phases use them: MLA (192, 128), 16 heads, 64 experts top-6."""
    cfg = ModelConfig.from_hf(DEEPSEEK_V2_LITE_CONFIG)
    x = cfg.extra
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads, cfg.vocab_size) == (2048, 27, 16, 102400)
    assert (x["qk_nope_head_dim"] + x["qk_rope_head_dim"], x["v_head_dim"], x["kv_lora_rank"]) == (192, 128, 512)
    assert (x["n_routed_experts"], x["num_experts_per_tok"], x["n_shared_experts"]) == (64, 6, 2)


# ---- the ops the model adds -------------------------------------------------


@pytest.mark.parametrize("scaling", [None, CASES["yarn"]["rope_scaling"]])
def test_interleaved_rope_matches(rng, scaling):
    from dnet_tpu.ops import rope as ref_rope

    inv_ref, sc_ref = ref_rope.rope_frequencies(64, 10000.0, scaling, 163840)
    inv, sc = rope.rope_frequencies(64, 10000.0, scaling, 163840)
    np.testing.assert_array_equal(inv, inv_ref)
    assert sc == sc_ref
    x = rng.normal(size=(2, 5, 3, 64)).astype(np.float32)
    pos = 300 + np.arange(5, dtype=np.int32)
    want = np.asarray(ref_rope.apply_rope_interleaved(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv_ref), sc_ref))
    got = rope.apply_rope_interleaved(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(inv), sc).numpy()
    np.testing.assert_allclose(got, want, **OP_TOL)
    # not the half-split convention
    half = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(inv), sc).numpy()
    assert not np.allclose(half, want, atol=1e-3)


@pytest.mark.parametrize("N", [1, 9])
def test_swiglu_expert_closures_match(rng, N):
    """effn over per-expert buffers and the dense every-token x every-expert
    sum, against the reference's closures on the same weights and routing."""
    from dnet_tpu.ops.moe import swiglu_expert_closures as ref_closures

    E, D, F, K = 4, 16, 8, 2
    p = {"e_gate": rng.normal(size=(E, D, F)), "e_up": rng.normal(size=(E, D, F)),
         "e_down": rng.normal(size=(E, F, D))}
    p = {k: (0.3 * v).astype(np.float32) for k, v in p.items()}
    flat = rng.normal(size=(N, D)).astype(np.float32)
    scores = rng.random(size=(N, E)).astype(np.float32)
    top_idx = np.argsort(-scores, axis=-1)[:, :K].astype(np.int32)
    top_w = np.take_along_axis(scores, top_idx, axis=-1)
    r_effn, r_dense, r_e = ref_closures({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(flat),
                                        jnp.asarray(scores), jnp.asarray(top_idx), jnp.asarray(top_w), None)
    effn, dense, e = moe.swiglu_expert_closures({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(flat),
                                                torch.from_numpy(top_idx), torch.from_numpy(top_w))
    assert e == r_e == E
    xe = rng.normal(size=(E, 3, D)).astype(np.float32)
    np.testing.assert_allclose(effn(torch.from_numpy(xe)).numpy(), np.asarray(r_effn(jnp.asarray(xe))), **OP_TOL)
    np.testing.assert_allclose(dense().numpy(), np.asarray(r_dense()), **OP_TOL)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_asymmetric_cache_matches(rng, bits):
    """init_cache / write_kv / read_kv / cache_nbytes with v_head_dim != head_dim:
    shapes, codes and scales bit-equal to the reference's, dequantized
    values within 2e-5."""
    from dnet_tpu.core.kvcache import KVConfig as RefKVConfig
    from dnet_tpu.core.kvcache import cache_nbytes as ref_nbytes
    from dnet_tpu.core.kvcache import init_cache as ref_init
    from dnet_tpu.core.kvcache import read_kv as ref_read
    from dnet_tpu.core.kvcache import write_kv as ref_write

    L, B, S, KVH, Hd, Vd = 2, 1, 16, 3, 24, 12
    ref_cfg = RefKVConfig(L, B, S, KVH, Hd, dtype="float32", v_head_dim=Vd, quant_bits=bits)
    cfg = KVConfig(L, B, S, KVH, Hd, dtype="float32", v_head_dim=Vd, quant_bits=bits)
    ref_cache, cache = ref_init(ref_cfg), init_cache(cfg, torch.device("cpu"))
    assert cache_nbytes(cfg) == ref_nbytes(ref_cfg)
    assert {n: tuple(t.shape) for n, t in cache.items()} == {n: tuple(a.shape) for n, a in ref_cache.items()}
    ref_l = {n: a[1] for n, a in ref_cache.items()}
    port_l = layer_slices(cache, 1)
    for pos, T in ((0, 5), (5, 1), (6, 7)):
        k = rng.normal(size=(B, T, KVH, Hd)).astype(np.float32)
        v = rng.normal(size=(B, T, KVH, Vd)).astype(np.float32)
        ref_l = ref_write(ref_l, jnp.asarray(k), jnp.asarray(v), jnp.int32(pos))
        write_kv(port_l, torch.from_numpy(k), torch.from_numpy(v), pos)
    for name in port_l:
        np.testing.assert_array_equal(port_l[name].numpy(), np.asarray(ref_l[name]))
    for got, want in zip(read_kv(port_l), ref_read(ref_l)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def test_int4_needs_even_head_dims():
    with pytest.raises(ValueError, match="even head dims"):
        init_cache(KVConfig(1, 1, 4, 1, 24, v_head_dim=11, quant_bits=4), torch.device("cpu"))
