"""Every model family on the port's ring shards, in process, against the
port's single-process engine and the reference's ring.

The byte-crossing ring harness (tests/torch_ring_harness.py) serves 2
prompts x 8 greedy steps through two shards of each family's tiny f32
checkpoint (tests/fakes/checkpoints.py): qwen2 (qkv biases), qwen3 (q/k
norms, the embedding tied on the tail), mixtral, qwen3_moe with
`mlp_only_layers=[0]` (the head's range starts on a dense layer) and with
`decoder_sparse_step=2` over [0] / [1, 2, 3], gpt_oss
paired [0,1] / [2,3] and flat [0] / [1,2,3] (a range whose sliding and
full kinds do not pair), and deepseek_v2 over [0,1] / [2,3] and [0] /
[1,2,3] (a dense-only head and a MoE-only tail).  The port's ring must give
the port's single-process tokens and the reference's ring's.  Beside them:
an int8 cache (mixtral), int8 weights (deepseek_v2) and the qsparse8 hop
codec (qwen3_moe), and streamed tails (mixtral at int8 weights, qwen3_moe
at int4, gpt_oss flat) against the single process and the reference's
ring at the same settings, a mixed ring (a reference shard beside a port
shard) over gpt_oss's flat split, the flat and segment-cut shards' hidden
states against the reference's shards at tests/test_torch_shard_engine.py's
tolerance (2e-3), and one process ring that loads gpt_oss flat and then
qwen3_moe with SSE byte-identical to the port's single-process server.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fakes import checkpoints
from tests.torch_ring_harness import MAX_SEQ, PROMPTS, _local_streams, _run_ring

pytestmark = [pytest.mark.ring, pytest.mark.shard]

TOL = 2e-3  # tests/test_torch_shard_engine.py's
PAIRED, FLAT = ([0, 1], [2, 3]), ([0], [1, 2, 3])
# checkpoint -> (family, config overrides, the splits its ring serves)
FAMILIES = {
    "qwen2": ("qwen2", {}, [PAIRED]),
    "qwen3": ("qwen3", {"tie_word_embeddings": True}, [PAIRED]),
    "mixtral": ("mixtral", {}, [PAIRED]),
    "qwen3_moe": ("qwen3_moe", {"mlp_only_layers": [0]}, [PAIRED]),
    # MoE on every second layer: s1's range starts on a MoE layer, ends on one
    "qwen3_moe-step2": ("qwen3_moe", {"decoder_sparse_step": 2}, [FLAT]),
    "gpt_oss": ("gpt_oss", {}, [PAIRED, FLAT]),
    "deepseek_v2": ("deepseek_v2", {}, [PAIRED, FLAT]),
}
TWO = PROMPTS[:2]


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    out = {}
    for name, (family, overrides, _) in FAMILIES.items():
        d = tmp_path_factory.mktemp(name)
        getattr(checkpoints, f"make_tiny_{family}")(d, overrides or None)
        out[name] = d
    return out


def _ids(split) -> str:
    return "-".join("".join(map(str, ls)) for ls in split)


@pytest.mark.parametrize("name,split", [(n, s) for n, (_, _, splits) in FAMILIES.items() for s in splits],
                         ids=lambda v: v if isinstance(v, str) else _ids(v))
def test_family_ring_matches_local_and_reference_ring(family_dirs, name, split):
    d = family_dirs[name]
    port, _, rts = asyncio.run(_run_ring(d, prompts=TWO, split=split))
    assert [rt.compute.layers for rt in rts] == list(split)
    assert port == _local_streams(d, prompts=TWO)
    ref, _, _ = asyncio.run(_run_ring(d, kinds=("ref", "ref"), api_kind="ref", prompts=TWO, split=split))
    assert port == ref


def test_gpt_oss_ranges_take_their_layouts(family_dirs):
    """A range whose kinds pair keeps the paired layout (its sliding half a
    W-row ring); an odd range takes the flat one: one full-length cache,
    every layer's kind kept."""
    from dnet_tpu_torch.core.engine import LocalEngine

    engines = {tuple(ls): LocalEngine(family_dirs["gpt_oss"], max_seq=MAX_SEQ, param_dtype="float32", device="cpu",
                                      layers=ls, shard_mode=True) for ls in ([0, 1], [0], [1, 2, 3])}
    paired, head, tail = engines[(0, 1)].model, engines[(0,)].model, engines[(1, 2, 3)].model
    assert paired.pair_kinds == (1, 0) and head.pair_kinds is None and tail.pair_kinds is None
    assert (head.layer_kinds, tail.layer_kinds) == ([1], [0, 1, 0])
    kv = tail.init_kv(3, 1, MAX_SEQ, "float32")
    assert kv["k"].shape[:3] == (3, 1, MAX_SEQ)
    assert tail.kv_rewindable(MAX_SEQ) and not paired.kv_rewindable(MAX_SEQ)
    assert not tail.supports_kv_commit and paired.supports_kv_commit


STREAMED_TAIL = {"shard_opts": ({}, {"window_size": 1})}
# (family, split, ring options, the single process's options)
SETTINGS = {
    "mixtral-kv8": ("mixtral", PAIRED, {"kv_bits": 8}, {"kv_bits": 8}),
    "mixtral-wq8-streamed": ("mixtral", PAIRED, {"weight_quant_bits": 8, **STREAMED_TAIL}, {"weight_quant_bits": 8}),
    "deepseek_v2-wq8": ("deepseek_v2", FLAT, {"weight_quant_bits": 8}, {"weight_quant_bits": 8}),
    "qwen3_moe-wq4-streamed": ("qwen3_moe", PAIRED, {"weight_quant_bits": 4, **STREAMED_TAIL},
                               {"weight_quant_bits": 4}),
    "gpt_oss-flat-streamed": ("gpt_oss", FLAT, STREAMED_TAIL, {}),
}


@pytest.mark.parametrize("case", list(SETTINGS))
def test_family_ring_at_other_settings_matches_local(family_dirs, case):
    """An int8 cache, int8 / int4 weights (the expert stacks quantized) and
    a tail that streams its layers one at a time (offload): the ring's
    greedy streams equal the single process's at the same settings and the
    reference's ring at the same load options."""
    from dnet_tpu_torch.ops.quant import is_quantized

    family, split, opts, local_opts = SETTINGS[case]
    d = family_dirs[family]
    port, _, rts = asyncio.run(_run_ring(d, prompts=TWO, split=split, **opts))
    assert port == _local_streams(d, prompts=TWO, **local_opts)
    ref, _, _ = asyncio.run(_run_ring(d, kinds=("ref", "ref"), api_kind="ref", prompts=TWO, split=split, **opts))
    assert port == ref
    engines = [rt.compute.engine for rt in rts]
    assert [e.kv_quant_bits for e in engines] == [opts.get("kv_bits", 0)] * 2
    assert [e.plan.name for e in engines] == ["fit", "offload" if "shard_opts" in opts else "fit"]
    bits = opts.get("weight_quant_bits", 0)
    assert [e.weight_quant_bits for e in engines] == [bits] * 2
    resident = [e.window_params for e in engines if e.plan.name == "fit"]
    layers = [p for w in resident for p in ([p for seg in w.values() for p in seg] if isinstance(w, dict) else w)]
    experts = [p[k] for p in layers for k in ("e_gate", "e_up", "e_down", "gate_up", "down") if k in p]
    assert experts and all(is_quantized(t) == bool(bits) for t in experts)


def test_qsparse8_family_ring_completes(family_dirs, monkeypatch):
    """The qsparse8 hop codec over qwen3_moe's shards (every column kept:
    pure int8 group quant on the wire) completes near the lossless stream,
    as the llama ring's qsparse8 test holds it."""
    from dnet_tpu.config import reset_settings_cache

    d = family_dirs["qwen3_moe"]
    monkeypatch.setenv("DNET_WIRE_QSPARSE_PCT", "0")
    reset_settings_cache()
    try:
        q8, net, _ = asyncio.run(_run_ring(d, prompts=TWO, codec="qsparse8"))
    finally:
        reset_settings_cache()
    assert all(len(s) == 8 for s in q8)
    assert sum(a == b for a, b in zip(q8, _local_streams(d, prompts=TWO))) >= 1
    assert net.bytes_to["s1"] > 0


def test_mixed_ring_over_gpt_oss_flat_split(family_dirs):
    """A reference shard over [0] beside a port shard over [1, 2, 3]: each
    unpacks the other's frames, and the greedy streams are the port's
    single process's."""
    d = family_dirs["gpt_oss"]
    streams, _, _ = asyncio.run(_run_ring(d, kinds=("ref", "port"), api_kind="ref", prompts=TWO, split=FLAT))
    assert streams == _local_streams(d, prompts=TWO)


def _shard_pairs(model_dir, split):
    from dnet_tpu.core.engine import LocalEngine as RefEngine
    from dnet_tpu_torch.core.engine import LocalEngine

    ref = [RefEngine(model_dir, layers=ls, max_seq=MAX_SEQ, param_dtype="float32", shard_mode=True) for ls in split]
    port = [LocalEngine(model_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", layers=ls, shard_mode=True)
            for ls in split]
    return ref, port


@pytest.mark.parametrize("family", ["gpt_oss", "deepseek_v2"])
def test_cut_shards_hidden_states_match_the_reference_shards(family_dirs, family):
    """gpt_oss's flat shards and deepseek_v2's dense-only / MoE-only shards
    ([0] / [1, 2, 3]) through a 12-token prompt and 8 decode steps: each
    shard's hidden state within 2e-3 of the reference shard's, the tail fed
    the reference head's real rows, padded again as a shard pads them."""
    from dnet_tpu_torch.core.engine import bucket_length

    ref, port = _shard_pairs(family_dirs[family], FLAT)
    ref_sess = [e.new_session("n", seed=0) for e in ref]
    port_sess = [e.new_session("n", seed=0) for e in port]
    rng = np.random.default_rng(0)
    ids, pos = [256, 72, 101, 108, 108, 111, 32, 119, 111, 114, 108, 100], 0
    for step in range(9):
        T = len(ids)
        toks = np.zeros((1, 1 if T == 1 else min(bucket_length(T), MAX_SEQ - pos)), np.int64)
        toks[0, :T] = ids
        xr, ref_sess[0].kv = ref[0]._embed_window(
            ref[0].window_params, ref[0].edge_params, jnp.asarray(toks, jnp.int32), ref_sess[0].kv,
            jnp.int32(pos), jnp.int32(T))
        xp = port[0].embed_window(port_sess[0], torch.from_numpy(toks), pos, t_real=T)
        assert np.abs(np.asarray(xr)[:, :T] - xp[:, :T].numpy()).max() <= TOL, ("head", step)
        h = np.zeros_like(np.asarray(xr))
        h[:, :T] = np.asarray(xr)[:, :T]
        yr, ref_sess[1].kv = ref[1]._hidden(ref[1].window_params, jnp.asarray(h), ref_sess[1].kv,
                                            jnp.int32(pos), jnp.int32(T))
        yp = port[1].run_layers(port_sess[1], torch.from_numpy(h), pos, t_real=T)
        assert np.abs(np.asarray(yr)[:, :T] - yp[:, :T].numpy()).max() <= TOL, ("tail", step)
        pos += T
        ids = [int(rng.integers(0, 256))]


def test_process_ring_reloads_families_with_single_process_sse(family_dirs, tmp_path):
    """Two `dnet_tpu_torch.cli.shard --device cpu` processes and the ring
    API: gpt_oss over its flat split, then qwen3_moe loaded in its place;
    each family's streamed and aggregate greedy chat is byte-identical,
    apart from `id` and `created`, to the port's single-process server,
    and each reload leaves the shards holding only the new model."""
    from tests.test_torch_ring_serving import CHAT, CpuRing, _normalize, _ring_requests, _single_process

    requests = [dict(CHAT, stream=True), dict(CHAT, max_tokens=8)]
    ring = CpuRing(tmp_path)
    try:
        for family, split in (("gpt_oss", FLAT), ("qwen3_moe", PAIRED)):
            d = family_dirs[family]
            ring.load(d, split)
            assert [ring.shard_health(i)["layers"] for i in range(2)] == list(split)
            assert [ring.shard_health(i)["model"] for i in range(2)] == [str(d)] * 2
            got = _ring_requests(ring, requests)
            want = _single_process(d, requests)
            assert [s for s, _ in got] == [s for s, _ in want] == [200, 200]
            assert [_normalize(b) for _, b in got] == [_normalize(b) for _, b in want], family
    finally:
        outcomes = ring.stop()
    for code, text in outcomes:
        assert code == 0, text


@pytest.mark.parametrize("family,layers", [("gpt_oss", [1, 2, 3]), ("gpt_oss", [2, 3]), ("deepseek_v2", [0]),
                                           ("deepseek_v2", [1, 2, 3]), ("qwen3_moe", [0, 1])],
                         ids=lambda v: v if isinstance(v, str) else "".join(map(str, v)))
def test_converter_carries_a_shard_ranges_params(family_dirs, family, layers):
    """models/convert.py takes a reference shard's stacked params (flat,
    paired or segmented) and its edge to the port's: stacked again by the
    port's model for that range, they are the port shard's own, leaf for
    leaf."""
    from dnet_tpu.core.engine import LocalEngine as RefEngine
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.models.convert import from_jax_params

    d = family_dirs[family]
    ref = RefEngine(d, layers=layers, max_seq=MAX_SEQ, param_dtype="float32", shard_mode=True)
    port = LocalEngine(d, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", layers=layers, shard_mode=True)
    to_np = lambda tree: {k: to_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}  # noqa: E731
    window, edge = from_jax_params(to_np(ref.window_params), to_np(ref.edge_params), port.config, "cpu",
                                   layers=layers)

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        if isinstance(tree, dict):
            return [t for k in sorted(tree) for t in leaves(tree[k])]
        return [t for v in tree for t in leaves(v)]

    got, want = leaves(port.model.stack_layers(window)), leaves(port.window_params)
    assert len(got) == len(want) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sorted(edge) == sorted(port.edge_params)
