"""The port's MeshEngine (sp = 2, both ranks on the CPU) against dnet_tpu's
MeshEngine(pp=1, tp=1, sp=2) and the port's LocalEngine on the tiny Llama
checkpoint (f32, max_seq 64).

The reference runs with DNET_FLASH_INTERPRET=1, so its sp decode steps go
through the kernel's jnp emulation as its own tests run it.  Prefill logits
within 2e-3 (the repo's parity tolerance, tests/test_llama_parity.py:40),
greedy streams identical token for token, through single steps and
through chunked decode; a 40-token prompt crosses the shard boundary at 32
(as tests/test_mesh_engine.py:105).
"""

import numpy as np
import pytest
import torch

from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts
from dnet_tpu_torch.models.convert import from_jax_params
from dnet_tpu_torch.parallel.engine import MeshEngine

pytestmark = [pytest.mark.core, pytest.mark.parallel]

TOL = dict(atol=2e-3, rtol=2e-3)
MAX_SEQ = 64
PROMPT = [256] + list(b"The quick brown fox")
LONG = [int(x) for x in np.random.default_rng(7).integers(1, 250, size=40)]


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNET_FLASH_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def ref_mesh(tiny_llama_dir, eight_devices):
    from dnet_tpu.parallel.engine import MeshEngine as RefMesh

    return RefMesh(tiny_llama_dir, pp=1, tp=1, sp=2, max_seq=MAX_SEQ, param_dtype="float32")


@pytest.fixture(scope="module")
def mesh(tiny_llama_dir):
    return MeshEngine(tiny_llama_dir, sp=2, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")


@pytest.fixture(scope="module")
def local(tiny_llama_dir):
    return LocalEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")


@pytest.mark.parametrize("prompt", [PROMPT, LONG], ids=["short", "across_boundary"])
def test_prefill_logits_match(mesh, ref_mesh, local, prompt):
    want = np.asarray(ref_mesh.prefill("p", prompt))
    got = mesh.prefill("p", prompt).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, local.prefill("p", prompt).numpy(), **TOL)
    # a second chunk continues the live session at its pos
    want2 = np.asarray(ref_mesh.prefill("p", [101, 102, 103]))
    np.testing.assert_allclose(mesh.prefill("p", [101, 102, 103]).numpy(), want2, **TOL)
    for e in (mesh, ref_mesh, local):
        e.end_session("p")


def _ref_greedy(ref_mesh, prompt, n):
    return [r.token_id for r in ref_mesh.generate(prompt, RefDecoding(), max_tokens=n, nonce="g")]


@pytest.mark.parametrize("prompt", [PROMPT, LONG], ids=["short", "across_boundary"])
def test_greedy_stream_by_single_steps(mesh, ref_mesh, local, prompt):
    """16 greedy tokens (the long prompt's decode fills rank 1's shard)."""
    got = [r.token_id for r in mesh.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]
    assert got == _ref_greedy(ref_mesh, prompt, 16)
    assert got == [r.token_id for r in local.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]


def test_greedy_stream_by_chunks(mesh, ref_mesh):
    """The serving path's chunked decode: the same 16 tokens."""
    d = DecodingParams()
    first = mesh.prefill_and_sample("c", PROMPT, d)
    toks = [int(first.token[0])]
    while len(toks) < 16:
        res = mesh.decode_chunk("c", toks[-1], d, 16 - len(toks))
        toks += [int(r.token[0]) for r in res]
    mesh.end_session("c")
    assert toks == _ref_greedy(ref_mesh, PROMPT, 16)


def test_decode_goes_through_the_lse_form_per_rank(mesh, monkeypatch):
    """Each decode step calls the LSE form once per rank per layer, with
    each rank's own live slots, and no single-device decode (on the CPU
    the calls take the plain version, so no kernel counter moves); the
    shards hold max_seq / 2 slots each."""
    import dnet_tpu_torch.ops.attention as attention
    import dnet_tpu_torch.ops.ring_attention as ring

    calls = []
    real = ring.flash_decode_lse

    def spy(q, k, v, lengths, max_live, scale=None, k_scale=None, v_scale=None):
        calls.append((int(lengths[0]), max_live))
        return real(q, k, v, lengths, max_live, scale=scale, k_scale=k_scale, v_scale=v_scale)

    monkeypatch.setattr(ring, "flash_decode_lse", spy)
    monkeypatch.setattr(attention, "flash_decode_attend", None)  # would raise if called
    reset_launch_counts()
    out = list(mesh.generate(LONG, DecodingParams(), max_tokens=4, nonce="k"))
    layers = mesh.config.num_hidden_layers
    assert len(out) == 4 and len(calls) == 3 * 2 * layers
    # steps at pos 40, 41, 42: rank 0 full (32 slots), rank 1 9, 10, 11
    assert calls[: 2 * layers] == [(32, 32), (9, 9)] * layers
    assert calls[-2:] == [(32, 32), (11, 11)]
    assert all(v == 0 for v in launch_counts().values())
    sess = mesh.new_session("s")
    assert [tuple(c["k"].shape[2:3]) for c in sess.kv] == [(MAX_SEQ // 2,)] * 2
    stats = mesh.stats()
    assert stats["sp"] == 2 and stats["devices"] == ["cpu", "cpu"]
    assert stats["kv_bytes_per_rank"] == [stats["kv_bytes"] // 2] * 2 and stats["kv_bytes"] > 0
    mesh.end_session("s")


def test_from_params_matches_checkpoint_engine(tiny_llama_dir, mesh):
    """from_params over weights converted from dnet_tpu's loaded params."""
    from dnet_tpu.core.engine import LocalEngine as RefEngine

    ref = RefEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32")
    cfg = mesh.config
    window, edge = from_jax_params(
        {k: np.asarray(v) for k, v in ref.window_params.items()},
        {g: {k: np.asarray(a) for k, a in leaves.items()} for g, leaves in ref.edge_params.items()},
        cfg, "cpu",
    )
    eng = MeshEngine.from_params(cfg, window, edge, sp=2, max_seq=MAX_SEQ, param_dtype="float32",
                                 devices=["cpu", "cpu"])
    got = eng.prefill("f", LONG)
    want = mesh.prefill("f", LONG)
    mesh.end_session("f")
    assert torch.allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "kw,match",
    [(dict(pp=2), "pp=2"), (dict(tp=2), "tp=2"), (dict(dp=2), "dp=2"), (dict(pp=2, kv_quant_bits=8), "pp=2"),
     (dict(tp=2, kv_quant_bits=4), "tp=2")],
)
def test_unported_mesh_refused(tiny_llama_dir, local, eight_devices, kw, match):
    """tp / dp stay refused, a quantized cache beside them too (a
    quantized cache under sp alone serves: tests/test_torch_sp_families.py).
    pp, once refused, serves: two stages of two sp ranks give the single
    device's greedy stream (plain cache), and the reference's MeshEngine's
    at the same mesh and bits (plain and q8)."""
    from dnet_tpu.parallel.engine import MeshEngine as RefMesh
    from dnet_tpu_torch.api.inference import EngineCapabilityError

    if "pp" in kw:
        eng = MeshEngine(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", **{"sp": 2, **kw})
        assert (eng.pp, eng.sp) == (2, 2) and eng.stages.stage_ranges() == [[0, 1], [2, 3]]
        got = [r.token_id for r in eng.generate(LONG, DecodingParams(), max_tokens=16, nonce="g")]
        ref = RefMesh(tiny_llama_dir, max_seq=MAX_SEQ, param_dtype="float32", **{"sp": 2, **kw})
        assert got == [r.token_id for r in ref.generate(LONG, RefDecoding(), max_tokens=16, nonce="g")]
        if not kw.get("kv_quant_bits"):
            assert got == [r.token_id for r in local.generate(LONG, DecodingParams(), max_tokens=16, nonce="g")]
        return
    with pytest.raises(EngineCapabilityError, match=match):
        MeshEngine(tiny_llama_dir, max_seq=MAX_SEQ, device="cpu", **{"sp": 2, **kw})


def test_other_families_refused(tmp_path, monkeypatch):
    """A family whose model takes no sp group is refused, naming the
    families that serve under sp (every registered one does now, so one is
    marked as not taking it here)."""
    from dnet_tpu_torch.api.inference import EngineCapabilityError
    from dnet_tpu_torch.models.gpt_oss import GptOssRingModel
    from tests.fakes.checkpoints import make_tiny_gpt_oss

    make_tiny_gpt_oss(tmp_path)
    monkeypatch.setattr(GptOssRingModel, "supports_sp", False)
    ported = "deepseek_v2, llama, mixtral, qwen2, qwen3, qwen3_moe"
    with pytest.raises(EngineCapabilityError, match=f"sp=2 for gpt_oss: .* ported for {ported} only"):
        MeshEngine(tmp_path, sp=2, max_seq=MAX_SEQ, device="cpu")


def test_sp_must_divide_max_seq_and_match_devices(tiny_llama_dir):
    with pytest.raises(ValueError, match="must divide"):
        MeshEngine(tiny_llama_dir, sp=3, max_seq=MAX_SEQ, device="cpu")
    with pytest.raises(ValueError, match="needs 2 rank devices"):
        MeshEngine(tiny_llama_dir, sp=2, max_seq=MAX_SEQ, devices=["cpu"])
