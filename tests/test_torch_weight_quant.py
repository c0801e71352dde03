"""The port's weight-only int8 / int4 quantization (dnet_tpu_torch/ops/quant.py
and the models' quantize hooks) against dnet_tpu's, on the same numpy
inputs made from a seed.

Codes and scales are equal bit for bit (q8 and q4; 2-D and stacked 3-D
expert weights; a group that tiles the in axis and one that does not; f32
and bf16 scales), an odd in axis raises for int4 in both, and `dq` /
`embed_lookup` equal the reference's exactly in f32 (0 tolerance).  The
edge follows tests/test_weight_quant.py: an untied LM head, a tied table
kept in the projection layout (its greedy stream equal to the reference's),
and a tied checkpoint that still serialises an lm_head.  Every family
(llama, qwen2, qwen3, mixtral, qwen3_moe, gpt_oss, deepseek_v2) at bits 8
and 4 holds the reference's quantized engine's prefill logits within 2e-3
(tests/test_llama_parity.py:40) and its greedy stream token for token, on
the same tiny checkpoint; the reference's quantized params also cross
through models/convert.py `from_jax_params` unchanged, and an engine made
from a generator of layers quantizes each as it arrives.

The reference runs its Pallas kernels in interpret mode
(DNET_FLASH_INTERPRET=1), the path it takes on the TPU.
"""

import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dnet_tpu.core.engine import LocalEngine as RefEngine
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu.ops import quant as ref_quant
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.models import ModelConfig, get_ring_model_cls
from dnet_tpu_torch.models.convert import from_jax_params
from dnet_tpu_torch.ops import quant

pytestmark = pytest.mark.core

TOL = dict(atol=2e-3, rtol=2e-3)
MAX_SEQ = 64
PROMPT = [256] + list(b"The quick brown fox")
N_TOKENS = 10
SCALE_DTYPES = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}
# (in, out) or (experts, in, out), and a group: 128 tiles 256 rows; 48 does
# not tile 64 (one group over the whole axis)
SHAPES = {"2d": ((256, 40), 128), "2d-untiled": ((64, 24), 48), "3d-experts": ((3, 128, 20), 32)}
FAMILIES = {
    "llama": "make_tiny_llama", "qwen2": "make_tiny_qwen2", "qwen3": "make_tiny_qwen3",
    "mixtral": "make_tiny_mixtral", "qwen3_moe": "make_tiny_qwen3_moe", "gpt_oss": "make_tiny_gpt_oss",
    "deepseek_v2": "make_tiny_deepseek_v2",
}


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNET_FLASH_INTERPRET", "1")
        yield


def _weight(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 0.05, shape).astype(np.float32)


def _np(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32) if np.asarray(a).dtype == ml_dtypes.bfloat16 else np.asarray(a)


def _quantize_both(w, bits, group, sd):
    ref_fn = ref_quant.quantize_weight_q4 if bits == 4 else ref_quant.quantize_weight_q8
    port_fn = quant.quantize_weight_q4 if bits == 4 else quant.quantize_weight_q8
    np_dtype, torch_dtype = SCALE_DTYPES[sd]
    return ref_fn(w, group, np_dtype), port_fn(torch.from_numpy(w), group, torch_dtype)


def _assert_same_codes(ref: dict, port: dict) -> None:
    key = "q4" if "q4" in ref else "q"
    assert set(port) == {key, "s"}
    assert port[key].dtype == (torch.uint8 if key == "q4" else torch.int8)
    np.testing.assert_array_equal(port[key].numpy(), np.asarray(ref[key]))
    np.testing.assert_array_equal(port["s"].float().numpy(), _np(ref["s"]))


@pytest.mark.parametrize("sd", list(SCALE_DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("bits", [8, 4])
def test_codes_and_scales_bit_equal(bits, shape, sd):
    dims, group = SHAPES[shape]
    ref, port = _quantize_both(_weight(dims), bits, group, sd)
    _assert_same_codes(ref, port)
    assert port["s"].dtype == SCALE_DTYPES[sd][1]
    assert port["s"].shape[-2] == (1 if shape == "2d-untiled" else dims[-2] // group)


def test_column_slices_change_no_code(monkeypatch):
    """A weight wider than one quantization pass is quantized in column
    slices: the same codes and scales as in one pass."""
    w = torch.from_numpy(_weight((128, 50)))
    whole = [quant.quantize_weight_q8(w, 32), quant.quantize_weight_q4(w, 32)]
    monkeypatch.setattr(quant, "CHUNK_ELEMS", 128 * 7)
    for got, want in zip([quant.quantize_weight_q8(w, 32), quant.quantize_weight_q4(w, 32)], whole):
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_int4_needs_an_even_in_axis_and_group():
    w = _weight((65, 8))
    with pytest.raises(ValueError, match="even contraction dim"):
        ref_quant.quantize_weight_q4(w)
    with pytest.raises(ValueError, match="even contraction dim"):
        quant.quantize_weight_q4(torch.from_numpy(w))
    with pytest.raises(ValueError, match="group_size must be even"):
        quant.quantize_weight_q4(torch.from_numpy(_weight((64, 8))), 33)


@pytest.mark.parametrize("bits", [8, 4])
def test_dq_and_embed_lookup_equal_the_reference(bits):
    """f32 scales: dequantized weights and gathered table rows equal the
    reference's exactly; a plain tensor passes through both."""
    ref, port = _quantize_both(_weight((3, 128, 20)), bits, 32, "f32")
    np.testing.assert_array_equal(quant.dq(port).numpy(), np.asarray(ref_quant.dq(ref)))
    assert quant.out_dim(port) == 20 and quant.lead_dim(port) == 3
    table = _weight((96, 64), seed=1)  # [vocab, hidden], stored as [hidden, vocab]
    ref, port = _quantize_both(np.ascontiguousarray(table.T), bits, 16, "f32")
    toks = np.random.default_rng(2).integers(0, 96, (2, 5))
    want = np.asarray(ref_quant.embed_lookup(ref, jnp.asarray(toks)))
    got = quant.embed_lookup(port, torch.from_numpy(toks))
    assert got.shape == (2, 5, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = torch.from_numpy(table)
    assert torch.equal(quant.embed_lookup(plain, torch.from_numpy(toks)), plain[torch.from_numpy(toks)])
    assert quant.dq(plain) is plain


def _tiny_llama_config(tied: bool) -> dict:
    return {"model_type": "llama", "vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
            "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
            "tie_word_embeddings": tied, "architectures": []}


@pytest.mark.parametrize("tied", [False, True])
def test_quantize_edge_equals_the_reference(tied):
    """The untied LM head, or a tied table re-laid out to [hidden, vocab],
    quantized to the reference's codes; a tied checkpoint's serialised
    lm_head is dropped (never read), and bits other than 8 / 4 raise."""
    from dnet_tpu.models.base import ModelConfig as RefConfig
    from dnet_tpu.models.llama import LlamaRingModel as RefLlama

    raw = _tiny_llama_config(tied)
    rng = np.random.default_rng(0)
    edge = {"embed": {"weight": rng.normal(0, 0.05, (64, 32)).astype(np.float32)},
            "lm_head": {"weight": rng.normal(0, 0.05, (32, 64)).astype(np.float32)},
            "final_norm": {"weight": np.ones(32, np.float32)}}
    model = get_ring_model_cls("llama")(ModelConfig.from_hf(raw), [0, 1], "cpu")
    port_edge = {k: {"weight": torch.from_numpy(v["weight"])} for k, v in edge.items()}
    for bits in (8, 4):
        want = RefLlama(RefConfig.from_hf(raw), [0, 1]).quantize_edge(edge, bits, np.float32, 16)
        got = model.quantize_edge(port_edge, bits, torch.float32, 16)
        assert sorted(got) == sorted(want)
        head = "embed" if tied else "lm_head"
        _assert_same_codes(want[head]["weight"], got[head]["weight"])
        assert ("lm_head" in got) is (not tied)
    with pytest.raises(NotImplementedError):
        model.quantize_edge(port_edge, 2)


def test_tied_table_serves_lookup_and_projection_from_one_array():
    """A tied model's quantized table (projection layout) is both the
    embedding and the LM head: the greedy stream equals the reference's
    engine on the same quantized params (tests/test_weight_quant.py:189)."""
    from dnet_tpu.core.engine import LocalEngine as RefLocal
    from dnet_tpu.models.base import ModelConfig as RefConfig
    from dnet_tpu.models.llama import LlamaRingModel as RefLlama
    from dnet_tpu.ops.quant import QUANTIZABLE, quantize_tree

    raw = dict(_tiny_llama_config(True), vocab_size=272, num_hidden_layers=3)
    rng = np.random.default_rng(3)
    w = lambda *s: rng.normal(0, 0.05, s).astype(np.float32)  # noqa: E731
    window = {"attn_norm": np.ones((3, 32), np.float32), "mlp_norm": np.ones((3, 32), np.float32),
              "wq": w(3, 32, 32), "wk": w(3, 32, 16), "wv": w(3, 32, 16), "wo": w(3, 32, 32),
              "w_gate": w(3, 32, 64), "w_up": w(3, 32, 64), "w_down": w(3, 64, 32)}
    edge = {"embed": {"weight": w(272, 32)}, "final_norm": {"weight": np.ones(32, np.float32)}}
    rcfg = RefConfig.from_hf(raw)
    qwin = quantize_tree(window, QUANTIZABLE, bits=8, group_size=16, scale_dtype=np.float32)
    qedge = RefLlama(rcfg, range(3)).quantize_edge(edge, 8, np.float32, 16)
    ref = RefLocal.from_params(rcfg, qwin, qedge, max_seq=MAX_SEQ, param_dtype="float32")
    cfg = ModelConfig.from_hf(raw)
    port = LocalEngine.from_params(cfg, [{k: torch.from_numpy(v[i]) for k, v in window.items()} for i in range(3)],
                                   {k: {"weight": torch.from_numpy(v["weight"])} for k, v in edge.items()},
                                   max_seq=MAX_SEQ, param_dtype="float32", device="cpu", weight_quant_bits=8,
                                   weight_quant_group=16)
    assert quant.is_quantized(port.edge_params["embed"]["weight"]) and "lm_head" not in port.edge_params
    _assert_same_codes(qedge["embed"]["weight"], port.edge_params["embed"]["weight"])
    want = [r.token_id for r in ref.generate(PROMPT[:6], RefDecoding(temperature=0.0), max_tokens=8)]
    assert [r.token_id for r in port.generate(PROMPT[:6], DecodingParams(), max_tokens=8)] == want


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    import tests.fakes.checkpoints as ck

    dirs = {}
    for family, maker in FAMILIES.items():
        dirs[family] = tmp_path_factory.mktemp(f"wq_{family}")
        # deepseek_v2 from seed 5: the default seed's greedy stream repeats one token
        getattr(ck, maker)(dirs[family], **({"seed": 5} if family == "deepseek_v2" else {}))
    return dirs


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_logits_and_greedy_stream(family_dirs, family, bits):
    """The port's engine quantizing at load against the reference's
    quantized engine on the same checkpoint: equal codes in every layer,
    logits within 2e-3, equal greedy streams."""
    d = family_dirs[family]
    ref = RefEngine(d, max_seq=MAX_SEQ, param_dtype="float32", weight_quant_bits=bits)
    port = LocalEngine(d, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", weight_quant_bits=bits)
    # the reference's stacked layers, carried across, hold the codes the port made
    cfg = ModelConfig.from_hf(json.loads((d / "config.json").read_text()))
    window, edge = from_jax_params(_tree_np(ref.window_params), _tree_np(ref.edge_params), cfg, "cpu")
    mine = port.window_params if isinstance(port.window_params, list) else _in_layer_order(port)
    for theirs, ours in zip(window, mine):
        assert sorted(theirs) == sorted(ours)
        for k in port.model.quant_keys & set(ours):
            assert quant.is_quantized(ours[k]) and all(torch.equal(ours[k][n], theirs[k][n]) for n in ours[k])
    head = "embed" if cfg.tie_word_embeddings else "lm_head"
    assert all(torch.equal(port.edge_params[head]["weight"][n], edge[head]["weight"][n]) for n in edge[head]["weight"])
    want = np.asarray(ref.prefill("p", PROMPT))
    np.testing.assert_allclose(port.prefill("p", PROMPT).numpy(), want, **TOL)
    ref.end_session("p")
    port.end_session("p")
    want = [r.token_id for r in ref.generate(PROMPT, RefDecoding(), max_tokens=N_TOKENS, nonce="g")]
    assert [r.token_id for r in port.generate(PROMPT, DecodingParams(), max_tokens=N_TOKENS, nonce="g")] == want


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _in_layer_order(engine):
    """The port's per-layer dicts in layer order from a paired (gpt_oss) or
    segmented (deepseek_v2) window."""
    wp = engine.window_params
    if set(wp) == {"a", "b"}:
        return [p for pair in zip(wp["a"], wp["b"]) for p in pair]
    return [p for seg in ("dense", "moe") for p in wp.get(seg, [])]


def test_from_jax_params_carries_quantized_leaves(family_dirs):
    """The reference's int4 codes and bf16 scales cross unchanged, and an
    engine around them (nothing left to quantize) serves the reference's
    logits."""
    d = family_dirs["deepseek_v2"]
    ref = RefEngine(d, max_seq=MAX_SEQ, param_dtype="float32", weight_quant_bits=4)
    cfg = ModelConfig.from_hf(json.loads((d / "config.json").read_text()))
    window, edge = from_jax_params(_tree_np(ref.window_params), _tree_np(ref.edge_params), cfg, "cpu")
    p = window[1]["e_gate"]
    assert p["q4"].dtype == torch.uint8 and p["s"].dtype == torch.float32 and p["q4"].shape[0] == 4
    port = LocalEngine.from_params(cfg, window, edge, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    np.testing.assert_allclose(port.prefill("p", PROMPT).numpy(), np.asarray(ref.prefill("p", PROMPT)), **TOL)
    bf16 = {"q": np.zeros((2, 4, 3), np.int8), "s": np.full((2, 1, 3), 0.375, ml_dtypes.bfloat16)}
    layers, _ = from_jax_params({"wq": bf16}, {}, dict_config(2), "cpu")
    assert layers[1]["wq"]["s"].dtype == torch.bfloat16 and layers[1]["wq"]["s"].float().eq(0.375).all()


def dict_config(n_layers: int) -> ModelConfig:
    return ModelConfig.from_hf(dict(_tiny_llama_config(False), num_hidden_layers=n_layers))


def test_layers_from_a_generator_quantize_as_they_arrive():
    """from_params over a generator of layers (utils/random_init.py
    random_llama_layers): each layer is quantized as it is made, to the
    codes of the same layers quantized from a list."""
    from dnet_tpu_torch.utils.random_init import random_llama_edge, random_llama_layers

    cfg = ModelConfig.from_hf(dict(_tiny_llama_config(False), num_hidden_layers=3))
    made = []

    def layers():
        for p in random_llama_layers(cfg, range(3), "cpu", torch.float32, seed=4):
            made.append(len(made))
            yield p

    kw = dict(max_seq=MAX_SEQ, param_dtype="float32", device="cpu", weight_quant_bits=4)
    eng = LocalEngine.from_params(cfg, layers(), random_llama_edge(cfg, "cpu", torch.float32, seed=5), **kw)
    again = LocalEngine.from_params(cfg, list(random_llama_layers(cfg, range(3), "cpu", torch.float32, seed=4)),
                                    random_llama_edge(cfg, "cpu", torch.float32, seed=5), **kw)
    assert made == [0, 1, 2]
    for a, b in zip(eng.window_params, again.window_params):
        assert torch.equal(a["w_down"]["q4"], b["w_down"]["q4"]) and torch.equal(a["wo"]["s"], b["wo"]["s"])
    stats = eng.stats()
    assert stats["weight_quant_bits"] == 4 and stats["weight_bytes"] == again.stats()["weight_bytes"]
    with pytest.raises(NotImplementedError, match="4 .packed int4. or 8"):
        LocalEngine.from_params(cfg, [], {}, device="cpu", weight_quant_bits=3)
