"""The port's weight-streaming LocalEngine against dnet_tpu's streaming
LocalEngine, on the same tiny checkpoints.

For llama, qwen2, gpt_oss (the paired layout: each streamed layer a window
of its half, the sliding half's cache a W-row ring) and deepseek_v2 (a
streamed layer in its dense or moe segment), at the plans (2, 4), (2, 1)
and (1, 1): the plan names are the reference's, the prompt's logits are
within 2e-3 of the reference's (tests/test_llama_parity.py:40) and the
greedy streams are equal, token for token.  deepseek_v2 at int8 weights
streams through the repack cache (written, then read back) to the port's
own fit engine's stream (the codes are the fit path's and the reference's,
tests/test_torch_weights.py).  Continuous batching over a
streaming plan is refused with EngineCapabilityError (422), as the
reference's is.

The reference runs its Pallas kernels in interpret mode
(DNET_FLASH_INTERPRET=1), the path it takes on the TPU.
"""

import numpy as np
import pytest
import torch

from dnet_tpu.core.engine import LocalEngine as RefEngine
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.types import DecodingParams

pytestmark = pytest.mark.core

TOL = dict(atol=2e-3, rtol=2e-3)
MAX_SEQ = 32
PROMPT = [256, 72, 105, 33, 7, 81, 99, 12, 40]  # longer than gpt_oss's 8-row window
N_TOKENS = 5
PLANS = [(2, 4, "offload"), (2, 1, "sliding_fit"), (1, 1, "offload")]
FAMILIES = {"llama": "make_tiny_llama", "qwen2": "make_tiny_qwen2", "gpt_oss": "make_tiny_gpt_oss",
            "deepseek_v2": "make_tiny_deepseek_v2"}


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNET_FLASH_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    from tests.fakes import checkpoints

    out = {}
    for fam, maker in FAMILIES.items():
        d = tmp_path_factory.mktemp(fam)
        getattr(checkpoints, maker)(d)
        out[fam] = d
    return out


def _run(eng, decoding, n_tokens=N_TOKENS) -> tuple:
    """(prompt logits [V] in f32, the greedy stream)."""
    logits = np.asarray(eng.prefill("p", PROMPT), dtype=np.float32).reshape(-1)
    eng.end_session("p")
    return logits, [r.token_id for r in eng.generate(PROMPT, decoding, max_tokens=n_tokens)]


@pytest.mark.parametrize("window,residency,plan", PLANS, ids=lambda v: str(v))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_streamed_engine_equals_the_reference(family_dirs, family, window, residency, plan):
    d = family_dirs[family]
    kw = dict(max_seq=MAX_SEQ, param_dtype="float32", window_size=window, residency_size=residency)
    ref = RefEngine(d, **kw)
    port = LocalEngine(d, device="cpu", **kw)
    try:
        assert port.plan.name == ref.plan.name == plan
        ref_logits, ref_toks = _run(ref, RefDecoding(temperature=0.0))
        logits, toks = _run(port, DecodingParams(temperature=0.0))
        np.testing.assert_allclose(logits, ref_logits, **TOL)
        assert toks == ref_toks
        s = port.stats()
        assert s["weight_policy"] == plan
        # nothing pinned after a pass: the budget holds (plus the prefetched window)
        assert len(port.weight_cache.resident_layers()) <= max(residency, window) + window
        assert s["weight_cache"]["loads"] > 0 and s["weight_cache"]["host_bytes"] > 0
    finally:
        port.close()
        ref.close()


def test_quantized_deepseek_streams_through_the_repack_cache(family_dirs, tmp_path):
    d = family_dirs["deepseek_v2"]
    kw = dict(max_seq=MAX_SEQ, param_dtype="float32", weight_quant_bits=8)
    fit = LocalEngine(d, device="cpu", **kw)
    _, fit_toks = _run(fit, DecodingParams(temperature=0.0), 4)
    for run in range(2):  # the second run reads the repack cache
        eng = LocalEngine(d, device="cpu", window_size=1, residency_size=2, repack_dir=str(tmp_path), **kw)
        try:
            assert eng.plan.streams_weights
            assert eng.weight_cache.store.repack_path is not None
            _, toks = _run(eng, DecodingParams(temperature=0.0), 4)
            assert toks == fit_toks, f"run {run}"
            assert len(list(eng.weight_cache.store.repack_path.glob("layer_*.safetensors"))) == 4
        finally:
            eng.close()


def test_batching_refuses_a_streaming_plan(family_dirs):
    from dnet_tpu.api.inference import EngineCapabilityError as RefCapabilityError
    from dnet_tpu.core.batch import BatchedEngine as RefBatched
    from dnet_tpu_torch.api.inference import EngineCapabilityError
    from dnet_tpu_torch.core.batch import BatchedEngine

    d = family_dirs["llama"]
    kw = dict(max_seq=MAX_SEQ, param_dtype="float32", window_size=1, residency_size=1)
    with pytest.raises(RefCapabilityError, match="needs resident weights") as ref_err:
        RefBatched(d, slots=2, **kw)
    with pytest.raises(EngineCapabilityError, match="needs resident weights") as err:
        BatchedEngine(d, slots=2, device="cpu", **kw)
    assert str(err.value) == str(ref_err.value)


def test_streamed_engine_from_params_equals_the_fit_engine(family_dirs):
    """`from_params` with a streaming plan packs each layer into host memory
    as it arrives: the same stream as a fit engine over the same params."""
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.utils.random_init import random_llama_layers, random_llama_edge

    cfg = ModelConfig.from_hf(dict(
        model_type="llama", vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0,
    ))
    dev = torch.device("cpu")

    def make(**kw):
        return LocalEngine.from_params(cfg, random_llama_layers(cfg, range(3), dev, torch.float32, seed=0),
                                       random_llama_edge(cfg, dev, torch.float32, seed=1), max_seq=MAX_SEQ,
                                       param_dtype="float32", device="cpu", **kw)

    fit, streamed = make(), make(window_size=2, residency_size=1)
    assert streamed.plan.name == "sliding_fit" and streamed.window_params is None
    assert _run(streamed, DecodingParams(temperature=0.0))[1] == _run(fit, DecodingParams(temperature=0.0))[1]
    streamed.close()
