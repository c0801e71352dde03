"""The port's MeshEngine (sp = 2, both ranks on the CPU) on the tiny gpt_oss
and deepseek_v2 checkpoints and under a quantized KV cache, against
dnet_tpu's MeshEngine(pp=1, tp=1, sp=2) and the port's LocalEngine (f32,
max_seq 64).

The reference runs with DNET_FLASH_INTERPRET=1, as its own tests run it.
Each case holds prefill logits within 2e-3 (tests/test_llama_parity.py:40)
for a short prompt and a 40-token one whose KV crosses the shard boundary
at 32, and 16 greedy tokens equal token for token to both engines':
gpt_oss plain and q8, deepseek_v2 plain, q8 and q4, llama q8 and q4.
gpt_oss under sp keeps flat caches for both halves (the reference's
`rotating=(sp == 1)`) and runs no decode kernel; so under q8 its sliding
layers attend a prompt's own keys quantized, where the single device's
ring attends them as computed (both packages alike), and its logits are
held to the reference's mesh engine only; deepseek_v2's decode rows
go through the LSE form at its MLA widths, over the codes when quantized.
The deepseek_v2 checkpoint is made from seed 5, whose greedy stream moves
(the default seed's repeats one token).
"""

import numpy as np
import pytest
import torch

from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.kvcache import cache_nbytes
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.models.convert import from_jax_params
from dnet_tpu_torch.parallel.engine import MeshEngine

pytestmark = [pytest.mark.core, pytest.mark.parallel]

TOL = dict(atol=2e-3, rtol=2e-3)
MAX_SEQ = 64
PROMPT = [256] + list(b"The quick brown fox")
LONG = [int(x) for x in np.random.default_rng(7).integers(1, 250, size=40)]
CASES = [("gpt_oss", 0), ("gpt_oss", 8), ("deepseek_v2", 0), ("deepseek_v2", 8), ("deepseek_v2", 4),
         ("llama", 8), ("llama", 4)]


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNET_FLASH_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory, tiny_llama_dir):
    from tests.fakes.checkpoints import make_tiny_deepseek_v2, make_tiny_gpt_oss

    oss = tmp_path_factory.mktemp("tiny_gpt_oss_sp")
    make_tiny_gpt_oss(oss)
    ds = tmp_path_factory.mktemp("tiny_deepseek_sp")
    make_tiny_deepseek_v2(ds, seed=5)
    return {"gpt_oss": oss, "deepseek_v2": ds, "llama": tiny_llama_dir}


def _engines(model_dirs, family, bits):
    from dnet_tpu.parallel.engine import MeshEngine as RefMesh

    d = model_dirs[family]
    kw = dict(max_seq=MAX_SEQ, param_dtype="float32", kv_quant_bits=bits)
    return (RefMesh(d, pp=1, tp=1, sp=2, **kw), MeshEngine(d, sp=2, device="cpu", **kw),
            LocalEngine(d, device="cpu", **kw))


@pytest.mark.parametrize("family,bits", CASES)
def test_prefill_logits_and_greedy_streams_match(model_dirs, family, bits):
    ref, mesh, local = _engines(model_dirs, family, bits)
    for prompt in (PROMPT, LONG):
        want = np.asarray(ref.prefill("p", prompt))
        got = mesh.prefill("p", prompt).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        if not (family == "gpt_oss" and bits):
            np.testing.assert_allclose(got, local.prefill("p", prompt).numpy(), **TOL)
        for e in (ref, mesh, local):
            e.end_session("p")
        want = [r.token_id for r in ref.generate(prompt, RefDecoding(), max_tokens=16, nonce="g")]
        got = [r.token_id for r in mesh.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]
        assert got == want
        assert got == [r.token_id for r in local.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]
    # the serving path's chunked decode gives the same stream
    d = DecodingParams()
    toks = [int(mesh.prefill_and_sample("c", LONG, d).token[0])]
    while len(toks) < 16:
        toks += [int(r.token[0]) for r in mesh.decode_chunk("c", toks[-1], d, 16 - len(toks))]
    mesh.end_session("c")
    assert toks == got


@pytest.mark.parametrize("family,bits", CASES)
def test_kv_bytes_per_rank_are_each_ranks_cache(model_dirs, family, bits):
    """Each rank holds max_seq / 2 slots in the model's layout: gpt_oss a
    paired cache whose two halves are both flat (no W-row ring), summed;
    deepseek_v2 the asymmetric MLA rows; codes and scales under q8 / q4."""
    mesh = MeshEngine(model_dirs[family], sp=2, max_seq=MAX_SEQ, param_dtype="float32", device="cpu",
                      kv_quant_bits=bits)
    sess = mesh.new_session("s")
    m = mesh.model
    L = len(m.layers)
    if family == "gpt_oss":
        cfg = m.kv_config(L // 2, 1, MAX_SEQ // 2, "float32", bits)
        want = 2 * cache_nbytes(cfg)
        assert [tuple(c[h]["k"].shape[:3]) for c in sess.kv for h in "ab"] == [(L // 2, 1, MAX_SEQ // 2)] * 4
    else:
        want = cache_nbytes(m.kv_config(L, 1, MAX_SEQ // 2, "float32", bits))
    stats = mesh.stats()
    assert stats["kv_bytes_per_rank"] == [want, want] and stats["kv_bytes"] == 2 * want
    assert stats["kv_quant_bits"] == bits and stats["sp"] == 2
    if family == "deepseek_v2" and bits == 4:
        # int4 MLA rows: K packs 192 / 2 = 12 bytes a head here (24 / 2), V 6
        assert sess.kv[0]["k"].shape[-1] == m.qk_head_dim // 2 and sess.kv[0]["v"].shape[-1] == m.v_head_dim // 2
    mesh.end_session("s")


@pytest.mark.parametrize("family,bits", [("deepseek_v2", 0), ("deepseek_v2", 8), ("deepseek_v2", 4),
                                         ("gpt_oss", 0), ("gpt_oss", 8)])
def test_decode_route_per_family(model_dirs, monkeypatch, family, bits):
    """deepseek_v2: every decode step calls the LSE form once per rank per
    layer with each rank's live slots (and its shard's scales when
    quantized); gpt_oss: no decode form at all, the dense sp attention
    under each half's masks, as in the reference."""
    import dnet_tpu_torch.ops.attention as attention
    import dnet_tpu_torch.ops.ring_attention as ring

    calls = []
    real = ring.flash_decode_lse

    def spy(q, k, v, lengths, max_live, scale=None, k_scale=None, v_scale=None):
        calls.append((int(lengths[0]), max_live, k_scale is not None, v.shape[-1]))
        return real(q, k, v, lengths, max_live, scale=scale, k_scale=k_scale, v_scale=v_scale)

    monkeypatch.setattr(ring, "flash_decode_lse", spy)
    monkeypatch.setattr(attention, "flash_decode_attend", None)  # would raise if called
    mesh = MeshEngine(model_dirs[family], sp=2, max_seq=MAX_SEQ, param_dtype="float32", device="cpu",
                      kv_quant_bits=bits)
    out = list(mesh.generate(LONG, DecodingParams(), max_tokens=4, nonce="k"))
    assert len(out) == 4
    if family == "gpt_oss":
        assert calls == []
        return
    layers = mesh.config.num_hidden_layers
    vd = mesh.model.v_head_dim // (2 if bits == 4 else 1)
    assert len(calls) == 3 * 2 * layers
    # steps at pos 40, 41, 42: rank 0 full (32 slots), rank 1 9, 10, 11
    assert calls[: 2 * layers] == [(32, 32, bool(bits), vd), (9, 9, bool(bits), vd)] * layers
    assert calls[-2:] == [(32, 32, bool(bits), vd), (11, 11, bool(bits), vd)]


@pytest.mark.parametrize("family", ["gpt_oss", "deepseek_v2"])
def test_from_params_matches_checkpoint_engine(model_dirs, family):
    """from_params over weights converted from dnet_tpu's loaded params
    (gpt_oss's paired stacks, deepseek_v2's {"dense", "moe"} segments): the
    same logits and stream as the checkpoint's mesh engine."""
    from dnet_tpu.core.engine import LocalEngine as RefEngine

    d = model_dirs[family]
    ref = RefEngine(d, max_seq=MAX_SEQ, param_dtype="float32")
    mesh = MeshEngine(d, sp=2, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    to_np = lambda tree: {k: to_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}  # noqa: E731
    window, edge = from_jax_params(to_np(ref.window_params), to_np(ref.edge_params), mesh.config, "cpu")
    eng = MeshEngine.from_params(mesh.config, window, edge, sp=2, max_seq=MAX_SEQ, param_dtype="float32",
                                 devices=["cpu", "cpu"])
    assert torch.allclose(eng.prefill("f", LONG), mesh.prefill("f", LONG), atol=1e-6, rtol=0)
    for e in (eng, mesh):
        e.end_session("f")
    streams = [[r.token_id for r in e.generate(LONG, DecodingParams(), max_tokens=8, nonce="g")] for e in (eng, mesh)]
    assert streams[0] == streams[1]


def test_gpt_oss_rewindable_under_sp(model_dirs):
    """A ring half is not rewindable; under sp no half is a ring."""
    mesh = MeshEngine(model_dirs["gpt_oss"], sp=2, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    assert not mesh.model.kv_rewindable(MAX_SEQ)
    assert mesh.model.kv_rewindable(MAX_SEQ, sp=2)
