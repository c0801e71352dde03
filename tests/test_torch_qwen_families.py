"""The port's qwen2, qwen3, mixtral and qwen3_moe against dnet_tpu's on the
same tiny checkpoints (tests/fakes/checkpoints.py: 4 layers, hidden 64,
4 query heads over 2 KV heads at head dim 16; mixtral and qwen3_moe with 4
experts top-2).

Cases: qwen2 (qkv biases), qwen3 (per-head q/k norms), mixtral (the sparse
MoE block, always renormalized), and qwen3_moe uniform with
`norm_topk_prob` true, uniform with it absent (transformers' default,
False), a dense prefix (`mlp_only_layers` [0, 1]) and interleaved
(`decoder_sparse_step` 2: layers 1 and 3 MoE).  Each holds prefill logits
within 2e-3 (tests/test_llama_parity.py:40) and identical greedy streams;
qwen3_moe also under capacity dispatch and over an int8 cache.
`from_jax_params` carries each family's reference pytrees across (the
stacked experts, the router, q/k norms, and the {"dense", "moe"} segment
stacks of the mixed layouts, interleaved back into layer order), and
`hf_tensors` writes a checkpoint the loader reads back to the same logits.

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
from dnet_tpu_torch.models import get_ring_model_cls
from dnet_tpu_torch.models.convert import from_jax_params, hf_tensors
from dnet_tpu_torch.utils.checkpoint import Checkpoint, save_checkpoint

pytestmark = pytest.mark.core

TOL = dict(atol=2e-3, rtol=2e-3)
MAX_SEQ = 64
PROMPT = [256] + list(b"The quick brown fox")
N_TOKENS = 16
# case -> (family, checkpoint maker, config overrides)
CASES = {
    "qwen2": ("qwen2", "make_tiny_qwen2", {}),
    "qwen3": ("qwen3", "make_tiny_qwen3", {}),
    "mixtral": ("mixtral", "make_tiny_mixtral", {}),
    "qwen3_moe": ("qwen3_moe", "make_tiny_qwen3_moe", {}),
    "qwen3_moe_no_renorm": ("qwen3_moe", "make_tiny_qwen3_moe", {"norm_topk_prob": None}),
    "qwen3_moe_prefix": ("qwen3_moe", "make_tiny_qwen3_moe", {"mlp_only_layers": [0, 1]}),
    "qwen3_moe_interleaved": ("qwen3_moe", "make_tiny_qwen3_moe", {"decoder_sparse_step": 2}),
}


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNET_FLASH_INTERPRET", "1")
        yield


def make_case(model_dir, case: str) -> None:
    """Write case `case`'s tiny checkpoint to model_dir (a None override
    drops the key from config.json)."""
    import json

    import tests.fakes.checkpoints as ck

    _, maker, overrides = CASES[case]
    getattr(ck, maker)(model_dir, {k: v for k, v in overrides.items() if v is not None})
    dropped = [k for k, v in overrides.items() if v is None]
    if dropped:
        path = model_dir / "config.json"
        raw = json.loads(path.read_text())
        for k in dropped:
            raw.pop(k)
        path.write_text(json.dumps(raw))


@pytest.fixture(scope="module")
def case_dirs(tmp_path_factory):
    dirs = {}
    for case in CASES:
        d = tmp_path_factory.mktemp(f"tiny_{case}")
        make_case(d, case)
        dirs[case] = d
    return dirs


def _pair(model_dir, bits=0, impl="dense"):
    ref = RefEngine(model_dir, max_seq=MAX_SEQ, param_dtype="float32", kv_quant_bits=bits)
    port = LocalEngine(model_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", kv_quant_bits=bits)
    ref.model.moe_impl = port.model.moe_impl = impl
    return ref, port


@pytest.fixture(scope="module")
def pairs(case_dirs):
    return {case: _pair(d) for case, d in case_dirs.items()}


def _greedy(engine, decoding, n=N_TOKENS):
    return [r.token_id for r in engine.generate(PROMPT, decoding, max_tokens=n, nonce="g")]


def _held(ref, port):
    """Prefill logits within 2e-3, then identical greedy streams."""
    want = np.asarray(ref.prefill("p", PROMPT))
    np.testing.assert_allclose(port.prefill("p", PROMPT).numpy(), want, **TOL)
    ref.end_session("p")
    port.end_session("p")
    assert _greedy(port, DecodingParams()) == _greedy(ref, RefDecoding())


def test_registry_resolves_every_family():
    for family in ("qwen2", "qwen3", "mixtral", "qwen3_moe"):
        assert get_ring_model_cls(family).model_type == family


@pytest.mark.parametrize("case", list(CASES))
def test_logits_and_greedy_stream(pairs, case):
    _held(*pairs[case])


def test_config_and_layout(pairs):
    """What each family reads from its config and maps from its checkpoint."""
    _, port = pairs["qwen2"]
    assert {"bq", "bk", "bv"} <= set(port.window_params[0])
    _, port = pairs["qwen3"]
    assert port.window_params[0]["q_norm"].shape == (16,) and port.config.head_dim == 16
    _, port = pairs["mixtral"]
    assert port.window_params[0]["e_gate"].shape == (4, 64, 96) and port.window_params[0]["gate_w"].shape == (64, 4)
    assert port.model.norm_topk_prob and port.model.quant_keys == pairs["mixtral"][0].model.quant_keys
    for case, renorm, kinds in (
        ("qwen3_moe", True, [True] * 4),
        ("qwen3_moe_no_renorm", False, [True] * 4),
        ("qwen3_moe_prefix", True, [False, False, True, True]),
        ("qwen3_moe_interleaved", True, [False, True, False, True]),
    ):
        ref, port = pairs[case]
        m = port.model
        assert m.norm_topk_prob is renorm and m.norm_topk_prob == ref.model.norm_topk_prob
        assert [m.is_moe_layer(a) for a in range(4)] == kinds
        assert ["e_gate" in p for p in port.window_params] == kinds
        assert ref.model.mixed == (not all(kinds))
        assert m.quant_keys == ref.model.quant_keys
        # the port's layer loop carries the paged hook through every layout
        assert m.supports_paged_attend and ref.model.supports_paged_attend == all(kinds)


def test_head_dim_decoupled_from_hidden(tmp_path):
    """Qwen3's head_dim is read, not derived: 4 heads x 32 = 128 != 64."""
    from tests.fakes.checkpoints import make_tiny_qwen3

    make_tiny_qwen3(tmp_path, {"head_dim": 32})
    ref, port = _pair(tmp_path)
    assert port.config.head_dim == 32 and port.window_params[0]["wq"].shape == (64, 128)
    _held(ref, port)


def test_qwen3_moe_dispatch_and_q8_cache(case_dirs):
    """qwen3_moe under capacity dispatch (1.25, with drops) and over an int8
    KV cache, each against the reference on the same path."""
    _held(*_pair(case_dirs["qwen3_moe_interleaved"], impl="dispatch"))
    _held(*_pair(case_dirs["qwen3_moe"], bits=8))


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("case", ["qwen2", "qwen3", "mixtral", "qwen3_moe_prefix", "qwen3_moe_interleaved"])
def test_from_jax_params_and_hf_round_trip(pairs, case_dirs, case, tmp_path):
    """The reference's pytrees carried across give its logits; hf_tensors
    writes them back as a checkpoint whose tensors equal the original's and
    which the loader serves to the same logits."""
    ref, port = pairs[case]
    window, edge = from_jax_params(_to_np(ref.window_params), _to_np(ref.edge_params), port.config, "cpu")
    assert [sorted(p) for p in window] == [sorted(p) for p in port.window_params]
    carried = LocalEngine.from_params(port.config, window, edge, max_seq=MAX_SEQ, param_dtype="float32",
                                      device="cpu")
    want = np.asarray(ref.prefill("j", PROMPT))
    ref.end_session("j")
    np.testing.assert_allclose(carried.prefill("j", PROMPT).numpy(), want, **TOL)

    src = Checkpoint(case_dirs[case])
    tensors = hf_tensors(window, edge, port.config.model_type)
    assert set(tensors) == {*src.edge_tensors, *(n for layer in src.layer_tensors.values() for n in layer.values())}
    for name, t in tensors.items():
        torch.testing.assert_close(t, src.load_tensor(name), rtol=0, atol=0)
    save_checkpoint(tmp_path, src.config, tensors)
    back = LocalEngine(tmp_path, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    np.testing.assert_allclose(back.prefill("r", PROMPT).numpy(), want, **TOL)
