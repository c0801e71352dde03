"""Pipeline parallelism on the port's MeshEngine (dnet_tpu_torch/parallel/
ring.py's stage plan) against dnet_tpu's MeshEngine at the same mesh on
the forced 8 host devices (tests/conftest.py), f32, max_seq 64, every rank
on the CPU.

For llama, gpt_oss, deepseek_v2 (two laps: dense slices, then moe slices)
and an interleaved qwen3_moe (`decoder_sparse_step` 2: chunk-aligned
stacks), at pp = 2, pp = 4 and pp = 2 x sp = 2, and a prefix-mixed
qwen3_moe (`mlp_only_layers` [0]: two laps) at pp = 2:
  - each pipeline rank holds the layers the reference puts on that rank
    (read from the reference's sharded stacks, pad rows left out);
  - prefill logits within 2e-3 (tests/test_llama_parity.py:40) for a short
    prompt and a 40-token one that crosses the sp shard boundary at 32;
  - 12 greedy ids equal, by single steps.
gpt_oss at pp = 4 puts one layer on each stage, whose kinds do not pair,
so each stage takes gpt_oss's flat layout; the reference cannot shard its
two 2-layer halves over 4 ranks (it raises at placement), so that case is
held against the port's single device.  Llama at pp = 2 and pp = 2 x sp = 2
with DNET_KV_BITS 8 and 4 against the reference at the same bits: logits
within 2e-3, greedy ids equal.  Also: the chunked decode and the
final-norm'd hidden states (/v1/embeddings) against the reference, pp = 0
resolving as the reference's does, and the reference's ValueError for a
flat stack that pp does not divide.
"""

import functools

import numpy as np
import pytest
import torch

from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.parallel.engine import MeshEngine

pytestmark = [pytest.mark.core, pytest.mark.parallel]

TOL = dict(atol=2e-3, rtol=2e-3)
MAX_SEQ = 64
PROMPT = [256] + list(b"The quick brown fox")
LONG = [int(x) for x in np.random.default_rng(7).integers(1, 250, size=40)]
FAMILIES = {
    "llama": ("make_tiny_llama", None),
    "gpt_oss": ("make_tiny_gpt_oss", None),
    "deepseek_v2": ("make_tiny_deepseek_v2", None),
    "qwen3_moe": ("make_tiny_qwen3_moe", {"decoder_sparse_step": 2}),
    "qwen3_moe_prefix": ("make_tiny_qwen3_moe", {"mlp_only_layers": [0]}),
}
MESHES = {"pp2": {"pp": 2}, "pp4": {"pp": 4}, "pp2sp2": {"pp": 2, "sp": 2}}
CASES = [(f, m) for f in ("llama", "gpt_oss", "deepseek_v2", "qwen3_moe") for m in MESHES] + [
    ("qwen3_moe_prefix", "pp2")]
REF_REFUSES = {("gpt_oss", "pp4")}


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DNET_FLASH_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    from tests.fakes import checkpoints

    out = {}
    for family, (maker, cfg) in FAMILIES.items():
        d = tmp_path_factory.mktemp(f"pp_{family}")
        getattr(checkpoints, maker)(d, cfg)
        out[family] = d
    return out


@pytest.fixture(scope="module")
def engines(model_dirs, eight_devices):
    """(port engine, reference engine or the port's LocalEngine) per case,
    built once for the module."""

    @functools.lru_cache(maxsize=None)
    def build(family, mesh_id):
        from dnet_tpu.parallel.engine import MeshEngine as RefMesh

        mesh = MESHES[mesh_id]
        d = model_dirs[family]
        n = mesh["pp"] * mesh.get("sp", 1)
        port = MeshEngine(d, max_seq=MAX_SEQ, param_dtype="float32", devices=["cpu"] * n, **{"sp": 1, **mesh})
        if (family, mesh_id) in REF_REFUSES:
            return port, LocalEngine(d, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
        return port, RefMesh(d, max_seq=MAX_SEQ, param_dtype="float32", **mesh)

    return build


def _ref_rank_layers(ref, model_dir) -> list:
    """Each pipeline rank's real layers in the reference's mesh engine: the
    `wo` rows of every stacked leaf on that rank's devices, matched to the
    checkpoint's o_proj weights (pad rows, all zero, match none)."""
    from jax.tree_util import tree_flatten_with_path

    from dnet_tpu_torch.utils.checkpoint import Checkpoint

    ckpt = Checkpoint(model_dir)
    L = ckpt.config["num_hidden_layers"]
    wo = [ckpt.load_layer_raw(a)["self_attn.o_proj.weight"].T.numpy() for a in range(L)]
    ckpt.close()
    pp_axis = ref.mesh.axis_names.index("pp")
    ranks = [set() for _ in range(ref.pp)]
    for path, leaf in tree_flatten_with_path(ref.window_params)[0]:
        if getattr(path[-1], "key", None) != "wo":
            continue
        for shard in leaf.addressable_shards:
            r = int(np.argwhere(ref.mesh.devices == shard.device)[0][pp_axis])
            for row in np.asarray(shard.data):
                ranks[r] |= {a for a in range(L) if np.array_equal(row, wo[a])}
    return [sorted(s) for s in ranks]


@pytest.mark.parametrize("family,mesh_id", CASES)
def test_each_stage_holds_the_reference_ranks_layers(engines, model_dirs, family, mesh_id):
    port, ref = engines(family, mesh_id)
    got = [sorted(ls) for ls in port.stages.stage_ranges()]
    if (family, mesh_id) in REF_REFUSES:
        assert got == [[0], [1], [2], [3]]
        assert all(run.model.pair_kinds is None for run in port.stages.runs)  # the flat layout
        return
    assert got == _ref_rank_layers(ref, model_dirs[family])
    port.new_session("kv")  # /health's cache bytes are a session's
    port.end_session("kv")
    stats = port.stats()
    assert stats["pp"] == MESHES[mesh_id]["pp"] and len(stats["stages"]) == stats["pp"]
    assert sum(stats["kv_bytes_per_stage"]) == stats["kv_bytes"] == sum(stats["kv_bytes_per_rank"]) > 0


@pytest.mark.parametrize("family,mesh_id", CASES)
def test_prefill_logits_match(engines, family, mesh_id):
    port, ref = engines(family, mesh_id)
    for prompt in (PROMPT, LONG):
        want = np.asarray(ref.prefill("p", prompt))
        got = port.prefill("p", prompt).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        port.end_session("p")
        ref.end_session("p")


@pytest.mark.parametrize("family,mesh_id", CASES)
def test_greedy_ids_match(engines, family, mesh_id):
    port, ref = engines(family, mesh_id)
    decoding = RefDecoding() if hasattr(ref, "mesh") else DecodingParams()
    want = [r.token_id for r in ref.generate(LONG, decoding, max_tokens=12, nonce="g")]
    got = [r.token_id for r in port.generate(LONG, DecodingParams(), max_tokens=12, nonce="g")]
    assert got == want


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mesh_id", ["pp2", "pp2sp2"])
def test_quantized_cache_matches(model_dirs, eight_devices, mesh_id, bits):
    """DNET_KV_BITS 8 / 4 under pp: each stage's cache in codes and scales,
    held against the reference's MeshEngine at the same bits: prefill
    logits within 2e-3 and 12 greedy ids equal, by single steps and by the
    chunked decode."""
    from dnet_tpu.parallel.engine import MeshEngine as RefMesh

    mesh = MESHES[mesh_id]
    d = model_dirs["llama"]
    kw = dict(max_seq=MAX_SEQ, param_dtype="float32", kv_quant_bits=bits)
    n = mesh["pp"] * mesh.get("sp", 1)
    port = MeshEngine(d, devices=["cpu"] * n, **{"sp": 1, **mesh}, **kw)
    ref = RefMesh(d, **mesh, **kw)
    assert port.stats()["kv_quant_bits"] == bits
    for prompt in (PROMPT, LONG):
        np.testing.assert_allclose(port.prefill("p", prompt).numpy(), np.asarray(ref.prefill("p", prompt)), **TOL)
        port.end_session("p")
        ref.end_session("p")
    want = [r.token_id for r in ref.generate(LONG, RefDecoding(), max_tokens=12, nonce="g")]
    assert [r.token_id for r in port.generate(LONG, DecodingParams(), max_tokens=12, nonce="g")] == want
    dp = DecodingParams()
    toks = [int(port.prefill_and_sample("c", LONG, dp).token[0])]
    while len(toks) < 12:
        toks += [int(r.token[0]) for r in port.decode_chunk("c", toks[-1], dp, 12 - len(toks))]
    port.end_session("c")
    assert toks == want


@pytest.mark.parametrize("family,mesh_id", [("llama", "pp2"), ("deepseek_v2", "pp2sp2"), ("gpt_oss", "pp2")])
def test_chunked_decode_matches(engines, family, mesh_id):
    """The serving path's chunked decode (LocalEngine's dispatch / read
    over the stage walk): the reference's 16 greedy ids."""
    port, ref = engines(family, mesh_id)
    d = DecodingParams()
    toks = [int(port.prefill_and_sample("c", PROMPT, d).token[0])]
    while len(toks) < 16:
        toks += [int(r.token[0]) for r in port.decode_chunk("c", toks[-1], d, 16 - len(toks))]
    port.end_session("c")
    assert toks == [r.token_id for r in ref.generate(PROMPT, RefDecoding(), max_tokens=16, nonce="c")]


@pytest.mark.parametrize("family,mesh_id", [("llama", "pp4"), ("deepseek_v2", "pp2"), ("qwen3_moe", "pp2sp2")])
def test_hidden_states_match(engines, family, mesh_id):
    port, ref = engines(family, mesh_id)
    np.testing.assert_allclose(port.hidden_states(LONG), ref.hidden_states(LONG), **TOL)


def test_decode_launches_run_through_every_stage(engines, monkeypatch):
    """A decode step runs each stage's layers on its own model, and the
    hidden state hops stage to stage: the walk's `.to` reaches each run's
    device (here all 'cpu')."""
    port, _ = engines("deepseek_v2", "pp4")
    seen = []
    for i, run in enumerate(port.stages.runs):
        real = run.model.apply_window

        def spy(*a, _i=i, _real=real, **kw):
            seen.append(_i)
            return _real(*a, **kw)

        monkeypatch.setattr(run.model, "apply_window", spy)
    list(port.generate(PROMPT, DecodingParams(), max_tokens=3, nonce="s"))
    # deepseek_v2 at pp = 4: lap 0 puts layer 0 (dense) on rank 0, lap 1 the
    # moe layers 1, 2, 3 on ranks 0, 1, 2 (rank 3 holds only pad rows)
    assert [(r.stage, r.layers) for r in port.stages.runs] == [(0, [0, 1]), (1, [2]), (2, [3])]
    assert seen == [0, 1, 2] * 3


def test_each_stages_launches_count_on_it(model_dirs, monkeypatch):
    """/health's per-stage launches: the walk credits each run's kernel
    launches to its stage (on the CPU no kernel runs, so each layer's
    forward counts one decode launch the way a wrapper counts its own)."""
    from dnet_tpu_torch.kernels.build import count_launch
    from dnet_tpu_torch.ops.flash_decode import flash_decode_attend

    monkeypatch.setattr(flash_decode_attend, "launches", flash_decode_attend.launches)  # restored after
    eng = MeshEngine(model_dirs["deepseek_v2"], pp=2, sp=1, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    for run in eng.stages.runs:
        real = run.model.apply_window

        def spy(*a, _real=real, _n=len(run.layers), **kw):
            for _ in range(_n):
                count_launch(flash_decode_attend)
            return _real(*a, **kw)

        monkeypatch.setattr(run.model, "apply_window", spy)
    list(eng.generate(PROMPT, DecodingParams(), max_tokens=4, nonce="l"))
    count_launch(flash_decode_attend)  # outside the walk: no stage's
    stages = eng.stats()["stages"]
    # a prefill and 3 decode steps: 4 forwards over stage 0's 3 layers and stage 1's 1
    assert [s["layers"] for s in stages] == [[0, 1, 2], [3]]
    assert [s["launches"] for s in stages] == [{"flash_decode": 12}, {"flash_decode": 4}]


def test_pp_must_divide_a_flat_stack(model_dirs):
    with pytest.raises(ValueError, match="pp=3 must divide num_layers=4"):
        MeshEngine(model_dirs["llama"], pp=3, sp=1, max_seq=MAX_SEQ, device="cpu")
    # a segmented stack pads instead: deepseek_v2 serves at pp = 3
    eng = MeshEngine(model_dirs["deepseek_v2"], pp=3, sp=1, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    assert eng.pp == 3


@pytest.mark.parametrize("n_devices,sp,want", [(4, 1, 4), (3, 1, 2), (8, 2, 4), (2, 2, 1)])
def test_pp_0_infers_from_the_devices(model_dirs, n_devices, sp, want):
    """pp = 0 takes the named devices over sp and walks down to a divisor
    of the layers (the reference's rule); no devices named and no cards:
    one stage."""
    eng = MeshEngine(model_dirs["llama"], pp=0, sp=sp, max_seq=MAX_SEQ, devices=["cpu"] * n_devices)
    assert eng.pp == want and len(eng.devices) == want * sp
    if sp == 2 and n_devices == 2:
        assert MeshEngine(model_dirs["llama"], pp=0, sp=2, max_seq=MAX_SEQ, device="cpu").pp == 1


def test_from_params_matches_the_checkpoint_engine(engines, model_dirs):
    """from_params over the checkpoint's layers places them stage by stage
    as the checkpoint engine does: the same logits."""
    from dnet_tpu_torch.utils.checkpoint import Checkpoint

    port, _ = engines("llama", "pp2")
    ckpt = Checkpoint(model_dirs["llama"])
    m = port.model
    window = [m.map_layer(ckpt.load_layer_raw(a)) for a in m.layers]
    edge = m.map_edge(ckpt.load_edge_raw())
    ckpt.close()
    eng = MeshEngine.from_params(port.config, iter(window), edge, pp=2, sp=1, max_seq=MAX_SEQ,
                                 param_dtype="float32", devices=["cpu", "cpu"])
    got, want = eng.prefill("f", LONG), port.prefill("f", LONG)
    port.end_session("f")
    assert torch.allclose(got, want, atol=1e-6, rtol=0)
