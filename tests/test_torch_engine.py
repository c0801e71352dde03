"""The port's LocalEngine against dnet_tpu's on the same tiny checkpoint.

Prefill logits: atol/rtol 2e-3, the repo's parity tolerance
(tests/test_llama_parity.py:40).  Greedy streams must be identical token
for token, through single steps and through chunked decode.
"""

import numpy as np
import pytest
import torch

from dnet_tpu.core.engine import LocalEngine as RefEngine
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.models import ModelConfig
from dnet_tpu_torch.models.convert import from_jax_params, hf_tensors
from dnet_tpu_torch.utils.checkpoint import Checkpoint, save_checkpoint
from dnet_tpu_torch.utils.random_init import random_llama_params

pytestmark = pytest.mark.core

TOL = dict(atol=2e-3, rtol=2e-3)
MAX_SEQ = 64
PROMPT = [256] + list(b"The quick brown fox")


@pytest.fixture(scope="module")
def ref_engine(tiny_llama_dir):
    return RefEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32")


@pytest.fixture(scope="module")
def engine(tiny_llama_dir):
    return LocalEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")


def test_prefill_logits_match(engine, ref_engine):
    want = np.asarray(ref_engine.prefill("p", PROMPT))
    got = engine.prefill("p", PROMPT).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # chunked prefill: a second chunk continues the live session at its pos
    want2 = np.asarray(ref_engine.prefill("p", [101, 102, 103]))
    got2 = engine.prefill("p", [101, 102, 103]).numpy()
    np.testing.assert_allclose(got2, want2, **TOL)
    engine.end_session("p")
    ref_engine.end_session("p")


def _ref_greedy(ref_engine, n):
    return [r.token_id for r in ref_engine.generate(PROMPT, RefDecoding(), max_tokens=n, nonce="g")]


def test_greedy_stream_by_single_steps(engine, ref_engine):
    got = [r.token_id for r in engine.generate(PROMPT, DecodingParams(), max_tokens=16, nonce="g")]
    assert got == _ref_greedy(ref_engine, 16)


def test_greedy_stream_by_chunks(engine, ref_engine):
    """Chunked decode (the serving path): the same 16 tokens."""
    d = DecodingParams()
    res = engine.prefill_and_sample("c", PROMPT, d)
    toks = [int(res.token[0])]
    engine.decode_chunk_dispatch("c", toks[-1], d, 8)
    engine.decode_chunk_dispatch("c", None, d, 4)  # chained from the device token
    for _ in range(2):
        toks += [int(r.token[0]) for r in engine.decode_chunk_read("c")]
    toks += [int(r.token[0]) for r in engine.decode_chunk("c", toks[-1], d, 3)]  # width 2
    toks.append(int(engine.decode_step("c", toks[-1], d).token[0]))
    assert engine.pending_chunks("c") == 0
    engine.end_session("c")
    assert toks == _ref_greedy(ref_engine, len(toks))
    assert len(toks) == 16


def test_sampled_stream_same_seed_same_tokens(engine):
    d = DecodingParams(temperature=0.9, top_k=50, seed=11, repetition_penalty=1.2)

    def run():
        return [r.token_id for r in engine.generate(PROMPT, d, max_tokens=10, nonce="s")]

    assert run() == run()


def test_from_jax_params_gives_the_same_logits(engine, ref_engine):
    """Weights carried across from the reference engine's own pytrees."""
    window, edge = from_jax_params(
        {k: np.asarray(v) for k, v in ref_engine.window_params.items()},
        {g: {k: np.asarray(a) for k, a in leaves.items()} for g, leaves in ref_engine.edge_params.items()},
        engine.config, "cpu",
    )
    carried = LocalEngine.from_params(
        engine.config, window, edge, max_seq=MAX_SEQ, param_dtype="float32", device="cpu"
    )
    want = np.asarray(ref_engine.prefill("j", PROMPT))
    ref_engine.end_session("j")
    np.testing.assert_allclose(carried.prefill("j", PROMPT).numpy(), want, **TOL)


def test_checkpoint_reader_matches_safetensors(tiny_llama_dir):
    """The port's own safetensors reader against the safetensors package on
    the file the reference's writer produced."""
    from safetensors.numpy import load_file

    want = load_file(str(tiny_llama_dir / "model.safetensors"))
    ck = Checkpoint(tiny_llama_dir)
    for name, arr in want.items():
        np.testing.assert_array_equal(ck.load_tensor(name).numpy(), arr)


def test_synthetic_checkpoint_round_trip(tmp_path):
    """random params -> HF tensors -> the port's writer -> the safetensors
    package and the engine's loader read back the same weights (bf16
    included) and the same logits as the in-memory engine."""
    from safetensors.torch import load_file

    cfg_dict = {
        "model_type": "llama", "vocab_size": 97, "hidden_size": 32,
        "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 8, "tie_word_embeddings": True,
    }
    cfg = ModelConfig.from_hf(cfg_dict)
    window, edge = random_llama_params(cfg, range(2), torch.device("cpu"), torch.bfloat16, seed=3)
    save_checkpoint(tmp_path, cfg_dict, hf_tensors(window, edge))
    back = load_file(str(tmp_path / "model.safetensors"))
    assert back["model.layers.1.self_attn.q_proj.weight"].dtype == torch.bfloat16
    torch.testing.assert_close(back["model.layers.1.self_attn.q_proj.weight"], window[1]["wq"].T)

    loaded = LocalEngine(tmp_path, max_seq=32, param_dtype="float32", device="cpu")
    direct = LocalEngine.from_params(cfg, window, edge, max_seq=32, param_dtype="float32", device="cpu")
    torch.testing.assert_close(loaded.prefill("a", [1, 2, 3]), direct.prefill("a", [1, 2, 3]))


def test_prompt_padding_never_runs_past_max_seq(engine):
    """A prompt whose pow2 bucket would overrun the cache is padded only to
    max_seq - pos (the KV write must fit)."""
    ids = list(range(1, MAX_SEQ - 3))  # 60 tokens
    engine.prefill("m", ids[:40])  # bucket 64 fills the cache exactly
    engine.prefill("m", ids[40:])  # 20 tokens at pos 40: bucket 32 cut to 24
    assert engine.sessions["m"].pos == len(ids)
    with pytest.raises(ValueError):
        engine.prefill("m", [1, 2, 3, 4, 5])
    engine.end_session("m")
