"""k-round schedules on port shards, against the reference's ring.

A non-contiguous assignment is a k-round schedule: each contiguous run of
a shard's layers is one visit of the activation a token (shard/compute.py
`_process_round`, core/engine.py `apply_round`).  The counterpart of
tests/subsystems/test_ring_two_shards.py's k = 2 case: s0 = [0, 2] and
s1 = [1, 3] of the tiny Llama, resident, with s1 streamed a layer a
window, and over an int8 cache (whose scales slice with the rounds), give
the reference ring's greedy tokens and the port's single process's; so do
a mixed k-round ring and gpt_oss's flat layout over [0, 1, 3] / [2].  The
ring manager deals the reference's rounds; a load that asks for lanes on
a k-round range, or a k-round range of resident layers that are not one
flat stack (gpt_oss paired, deepseek_v2, a mixed qwen3_moe), is refused
at load, naming why; and a `/v1/prepare_topology` solve under constrained
device memory deals k = 2 rounds, which two port shards load and serve
with the single process's text.
"""

import asyncio

import pytest

from tests.fakes import checkpoints
from tests.torch_ring_harness import MAX_SEQ, PROMPTS, HttpRing, _local_streams, _run_ring

pytestmark = [pytest.mark.ring, pytest.mark.shard]

K2 = ([0, 2], [1, 3])
TWO = PROMPTS[:2]


@pytest.fixture(scope="module")
def local_greedy(tiny_llama_dir):
    return _local_streams(tiny_llama_dir, prompts=TWO)


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    out = {}
    for name, family, overrides in (("gpt_oss", "gpt_oss", None), ("deepseek_v2", "deepseek_v2", None),
                                    ("qwen3_moe-mixed", "qwen3_moe", {"mlp_only_layers": [0]})):
        d = tmp_path_factory.mktemp(name)
        getattr(checkpoints, f"make_tiny_{family}")(d, overrides)
        out[name] = d
    return out


@pytest.mark.parametrize("case", ["resident", "s1-streamed", "kv8"])
def test_k2_rounds_match_reference_ring_and_local(tiny_llama_dir, local_greedy, case):
    opts, kv_bits = {"resident": (({}, {}), 0), "s1-streamed": (({}, {"window_size": 1}), 0),
                     "kv8": (({}, {}), 8)}[case]
    port, _, rts = asyncio.run(_run_ring(tiny_llama_dir, prompts=TWO, split=K2, shard_opts=opts, kv_bits=kv_bits))
    assert [rt.compute.rounds for rt in rts] == [[[0], [2]], [[1], [3]]]
    assert rts[1].compute.engine.plan.streams_weights == (case == "s1-streamed")
    ref, _, _ = asyncio.run(_run_ring(tiny_llama_dir, kinds=("ref", "ref"), api_kind="ref", prompts=TWO, split=K2,
                                      shard_opts=opts, kv_bits=kv_bits))
    assert port == ref
    assert port == (local_greedy if not kv_bits else _local_streams(tiny_llama_dir, prompts=TWO, kv_bits=kv_bits))


@pytest.mark.parametrize("kinds", [("ref", "port"), ("port", "ref")], ids=["ref_head", "port_head"])
def test_mixed_k2_ring(tiny_llama_dir, local_greedy, kinds):
    streams, _, _ = asyncio.run(_run_ring(tiny_llama_dir, kinds=kinds, api_kind=kinds[1], prompts=TWO, split=K2))
    assert streams == local_greedy


def test_gpt_oss_flat_k_round_ring(family_dirs):
    """s0 = [0, 1, 3]: an odd range, so gpt_oss's flat layout, in rounds
    [0, 1] and [3], each layer under its own kind; the reference's ring
    and the single process give the same tokens."""
    d = family_dirs["gpt_oss"]
    split = ([0, 1, 3], [2])
    port, _, rts = asyncio.run(_run_ring(d, prompts=TWO, split=split))
    assert rts[0].compute.rounds == [[0, 1], [3]] and rts[0].compute.engine.model.pair_kinds is None
    ref, _, _ = asyncio.run(_run_ring(d, kinds=("ref", "ref"), api_kind="ref", prompts=TWO, split=split))
    assert port == ref == _local_streams(d, prompts=TWO)


def test_manual_topology_rounds_equal_the_references(tiny_llama_dir):
    from dnet_tpu.api.ring_manager import build_manual_topology as ref_build
    from dnet_tpu.core.types import DeviceInfo as RefDevice
    from dnet_tpu_torch.api.ring_manager import build_manual_topology
    from dnet_tpu_torch.core.types import DeviceInfo

    for assignments in ([{"instance": "s0", "layers": [0, 2]}, {"instance": "s1", "layers": [3, 1]}],
                        [{"instance": "s1", "layers": [2]}, {"instance": "s0", "layers": [0, 1, 3]}],
                        [{"instance": "s0", "layers": [0, 1]}, {"instance": "s1", "layers": [2, 3]}]):
        port = build_manual_topology("m", 4, assignments, [DeviceInfo(f"s{i}", "h", 1, 2) for i in range(2)])
        ref = ref_build("m", 4, assignments, [RefDevice(f"s{i}", "h", 1, 2) for i in range(2)])
        assert [(a.instance, a.rounds, a.next_instance) for a in port.assignments] == \
               [(a.instance, a.rounds, a.next_instance) for a in ref.assignments]


@pytest.mark.parametrize("case", ["lanes", "gpt_oss-paired", "deepseek_v2", "qwen3_moe-mixed"])
def test_k_round_loads_refused_naming_why(tiny_llama_dir, family_dirs, case):
    """Refused at load, before a weight is read (the reference refuses lanes
    at load and the stacks on the first frame); the same range streamed is
    served."""
    from dnet_tpu_torch.shard.compute import ShardCapabilityError
    from dnet_tpu_torch.shard.runtime import ShardRuntime

    model_dir, opts, why = {
        "lanes": (tiny_llama_dir, {"lanes": 2}, "k-round"),
        "gpt_oss-paired": (family_dirs["gpt_oss"], {}, "paired layout"),
        "deepseek_v2": (family_dirs["deepseek_v2"], {}, "segmented layer stack"),
        "qwen3_moe-mixed": (family_dirs["qwen3_moe-mixed"], {}, "segmented layer stack"),
    }[case]
    rt = ShardRuntime("s0", device="cpu")
    with pytest.raises(ShardCapabilityError, match="does not serve") as exc:
        rt.load_model_core(str(model_dir), [0, 2], max_seq=MAX_SEQ, param_dtype="float32", **opts)
    assert why in str(exc.value) and "[0, 2]" in str(exc.value)
    assert rt.compute is None
    if case != "lanes":
        rt.load_model_core(str(model_dir), [0, 2], max_seq=MAX_SEQ, param_dtype="float32", window_size=1)
        assert rt.compute.rounds == [[0], [2]]
        rt.unload_model_core()


def test_prepare_topology_deals_k2_rounds_that_port_shards_serve(tiny_llama_dir, monkeypatch, tmp_path):
    """Both shards' profiles say their device memory holds one layer of the
    two each is dealt (the reference's constrained-memory solve): the
    solver deals k = 2 rounds, each shard streaming a layer a window, and
    the two port shards load them and answer the single process's text."""
    import dnet_tpu_torch.parallel.profiler as profiler
    from dnet_tpu_torch.parallel.solver import model_profile_from_checkpoint

    m = model_profile_from_checkpoint(tiny_llama_dir, seq_len=MAX_SEQ)
    per_layer = m.layer_bytes + m.kv_bytes_per_token_per_layer * m.seq_len
    hbm = int((m.edge_bytes + 1.5 * per_layer) / 0.85)  # one layer fits (15% reserve)
    monkeypatch.setattr(profiler, "profile_device", lambda device=None: {
        "device_kind": "cpu", "platform": "cpu", "flops_bf16": 1e12, "hbm_bw": 1e11, "host_to_hbm_bw": 1e10,
        "host_ram_bytes": 1 << 34, "local_device_count": 1, "hbm_bytes": hbm, "hbm_in_use": 0})
    monkeypatch.setenv("DNET_TOPOLOGY_SOLVER", "greedy")
    monkeypatch.setenv("DNET_SHARD_REPACK_DIR", str(tmp_path / "repacked"))

    async def go():
        ring = HttpRing("dnet_tpu_torch", tiny_llama_dir)
        await ring.setup()
        try:
            r = await ring.client.post("/v1/prepare_topology", json={"model": str(tiny_llama_dir),
                                                                     "seq_len": MAX_SEQ})
            topo = (await r.json())["topology"]
            r = await ring.client.post("/v1/load_model", json={"model": str(tiny_llama_dir)})
            status, text = r.status, await r.text()
            out = await ring.chat("p0", max_tokens=8, stream=False)
            shards = {n: (s.runtime.compute.rounds, s.runtime.compute.engine.plan.name) for n, s in ring.shards.items()}
            return topo, status, text, out, shards
        finally:
            await ring.stop()

    topo, status, text, out, shards = asyncio.run(go())
    assert topo["solution"]["k"] == 2, topo
    assert status == 200, text
    assert shards == {"s0": ([[0], [2]], "offload"), "s1": ([[1], [3]], "offload")}
    assert out == (200, _local_text(tiny_llama_dir, "p0"))


def _local_text(model_dir, content):
    """The single-process server's greedy chat text for `content`."""
    from aiohttp.test_utils import TestClient, TestServer

    from dnet_tpu_torch.api.http import ApiHTTPServer
    from dnet_tpu_torch.api.inference import InferenceManager
    from dnet_tpu_torch.api.model_manager import LocalModelManager

    async def go():
        inference = InferenceManager(adapter=None)
        manager = LocalModelManager(inference, max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
        client = TestClient(TestServer(ApiHTTPServer(inference, manager).app))
        await client.start_server()
        try:
            r = await client.post("/v1/load_model", json={"model": str(model_dir)})
            assert r.status == 200, await r.text()
            r = await client.post("/v1/chat/completions", json={
                "model": str(model_dir), "messages": [{"role": "user", "content": content}], "max_tokens": 8,
                "temperature": 0, "stream": False})
            return (await r.json())["choices"][0]["message"]["content"]
        finally:
            await client.close()

    return asyncio.run(go())
