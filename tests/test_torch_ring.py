"""The port's pipelined shard ring, in process: an API adapter and two
shards (layers [0,1] and [2,3] of the tiny Llama) wired through fake ring
clients that pass the packed frame, ACK and token bytes across, the
counterpart of tests/subsystems/test_ring_two_shards.py.

Because every hop crosses as msgpack bytes, either package's node can sit
at either end of a hop: the mixed rings put a dnet_tpu shard beside a port
shard.  Greedy streams must equal the port's single-process engine and
dnet_tpu's own ring, token for token; seeded sampling must equal the
port's single-process stream.
"""

import asyncio
import dataclasses

import pytest

import dnet_tpu_torch.transport.protocol as port_proto
from dnet_tpu_torch.core.types import DecodingParams
from tests.torch_ring_harness import MAX_SEQ, PROMPTS, STEPS, Net, _local_streams, _port_shard, _run_ring

pytestmark = [pytest.mark.ring, pytest.mark.shard]


@pytest.fixture(scope="module")
def local_greedy(tiny_llama_dir):
    return _local_streams(tiny_llama_dir)


@pytest.mark.parametrize("auto_steps", [16, 0])
def test_greedy_ring_matches_local_and_reference_ring(tiny_llama_dir, local_greedy, auto_steps):
    port, _, _ = asyncio.run(_run_ring(tiny_llama_dir, auto_steps=auto_steps))
    ref, _, _ = asyncio.run(_run_ring(tiny_llama_dir, kinds=("ref", "ref"), api_kind="ref",
                                      auto_steps=auto_steps))
    assert port == local_greedy
    assert port == ref


def test_seeded_sampling_with_grants_matches_local(tiny_llama_dir):
    dec = DecodingParams(temperature=0.8, top_p=0.95, seed=1234)
    ring, _, _ = asyncio.run(_run_ring(tiny_llama_dir, decoding=dec, prompts=PROMPTS[:2]))
    assert ring == _local_streams(tiny_llama_dir, dec, prompts=PROMPTS[:2])


@pytest.mark.parametrize("kv_bits", [8, 4, 16])
def test_quantized_kv_ring_matches_local_and_reference_ring(tiny_llama_dir, kv_bits):
    """kv_bits from the topology: each shard's cache is int8 / packed int4
    (or bf16 under f32 params), and the ring's greedy stream equals the
    single process's with the same cache, and dnet_tpu's ring's."""
    port, _, rts = asyncio.run(_run_ring(tiny_llama_dir, prompts=PROMPTS[:2], kv_bits=kv_bits))
    assert [rt.compute.engine.kv_quant_bits for rt in rts] == [0 if kv_bits == 16 else kv_bits] * 2
    assert port == _local_streams(tiny_llama_dir, prompts=PROMPTS[:2], kv_bits=kv_bits)
    ref, _, _ = asyncio.run(_run_ring(tiny_llama_dir, kinds=("ref", "ref"), api_kind="ref", prompts=PROMPTS[:2],
                                      kv_bits=kv_bits))
    assert port == ref


def test_decode_grants_feed_the_tail_back_to_the_head(tiny_llama_dir):
    """An 8-token request under a 16-token grant: the API's step-0 frame
    grants the 7 steps after it, and the tail injects each of those steps
    at the head with the grant counting down; without grants the API sends
    every step."""
    _, net, _ = asyncio.run(_run_ring(tiny_llama_dir, prompts=PROMPTS[:1]))
    assert net.token_frames == [("s0", k, 7 - k) for k in range(STEPS)]
    _, net, _ = asyncio.run(_run_ring(tiny_llama_dir, prompts=PROMPTS[:1], auto_steps=0))
    assert net.token_frames == [("s0", k, 0) for k in range(STEPS)]


@pytest.fixture
def qsparse_pct0(monkeypatch):
    """qsparse8 keeping every column: pure int8 group quant on the wire."""
    from dnet_tpu.config import reset_settings_cache

    monkeypatch.setenv("DNET_WIRE_QSPARSE_PCT", "0")
    reset_settings_cache()
    yield
    reset_settings_cache()


def test_qsparse8_ring_completes_near_lossless_at_fewer_bytes(tiny_llama_dir, local_greedy, qsparse_pct0):
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    q8, net_q8, _ = asyncio.run(_run_ring(tiny_llama_dir, codec="qsparse8"))
    _, net_lossless, _ = asyncio.run(_run_ring(tiny_llama_dir))
    assert all(len(s) == STEPS for s in q8)
    # the tolerance of test_pipeline_qsparse8_token_parity_tolerance
    assert sum(a == b for a, b in zip(q8, local_greedy)) >= 2
    assert 0 < net_q8.bytes_to["s1"] < net_lossless.bytes_to["s1"]
    # on the CPU the wrappers take their plain versions: nothing launched
    assert not any(launch_counts().values())


def test_sparse_v1_transport_compression_ring(tiny_llama_dir, local_greedy, monkeypatch):
    """DNET_TRANSPORT_COMPRESS under the lossless codec: sparse_v1 hops
    (kept columns verbatim) into a dnet_tpu tail, at fewer bytes."""
    from dnet_tpu.config import reset_settings_cache

    _, net_lossless, _ = asyncio.run(_run_ring(tiny_llama_dir, prompts=PROMPTS[:1]))
    monkeypatch.setenv("DNET_TRANSPORT_COMPRESS", "1")
    monkeypatch.setenv("DNET_TRANSPORT_COMPRESS_PCT", "0.25")
    reset_settings_cache()
    try:
        streams, net, _ = asyncio.run(_run_ring(tiny_llama_dir, kinds=("port", "ref"), prompts=PROMPTS[:1]))
    finally:
        reset_settings_cache()
    assert len(streams[0]) == STEPS
    assert 0 < net.bytes_to["s1"] < net_lossless.bytes_to["s1"]


@pytest.mark.parametrize("kinds", [("ref", "port"), ("port", "ref")], ids=["ref_head", "port_head"])
def test_mixed_ring_lossless_greedy_matches(tiny_llama_dir, local_greedy, kinds):
    """A dnet_tpu shard and a port shard in one ring, each side unpacking
    the other's frames and tokens: greedy streams equal the port's
    single-process engine."""
    api_kind = kinds[0]
    for auto_steps in (16, 0):
        streams, _, _ = asyncio.run(_run_ring(tiny_llama_dir, kinds=kinds, api_kind=api_kind,
                                              auto_steps=auto_steps))
        assert streams == local_greedy


@pytest.mark.parametrize("kinds", [("ref", "port"), ("port", "ref")], ids=["ref_head", "port_head"])
def test_mixed_ring_qsparse8_completes(tiny_llama_dir, local_greedy, qsparse_pct0, kinds):
    """The qsparse8 frames one package encodes decode in the other."""
    streams, net, _ = asyncio.run(_run_ring(tiny_llama_dir, kinds=kinds, api_kind=kinds[1], codec="qsparse8"))
    assert all(len(s) == STEPS for s in streams)
    assert sum(a == b for a, b in zip(streams, local_greedy)) >= 2
    assert net.bytes_to["s1"] > 0


REFUSED = [
    dict(lanes=2), dict(spec_lookahead=4), dict(prefix_cache=4), dict(layers=[0, 2]),
    dict(mesh_tp=2), dict(mesh_tp=-1), dict(mesh_sp=2), dict(tp_degree=2), dict(kv_bits=3),
    dict(weight_quant_bits=3), dict(wire_pipeline=True),
]
# refused until lanes, the wire pipeline, ring speculation, the ring prefix
# cache and k-round schedules were ported, served since (the case ids are
# kept): lanes=2 loads a two-lane pool, wire_pipeline=True the encode ring,
# spec_lookahead=4 a speculating shard, prefix_cache=4 a 4-entry snapshot
# store, layers=[0, 2] two rounds
SERVED_NOW = ("lanes=2", "wire_pipeline=True", "spec_lookahead=4", "prefix_cache=4", "layers=[0, 2]")
# once refused, now served: a window streams the tail shard's weights
# (offload over its 2 layers); a residency of all its layers alone is fit
STREAMING = [(dict(window_size=1), "offload"), (dict(residency_size=2), "fit")]


def _option_id(option: dict) -> str:
    return "-".join(f"{k}={v}" for k, v in option.items())


@pytest.mark.parametrize("option", REFUSED, ids=_option_id)
def test_refused_load_options_raise(tiny_llama_dir, option):
    """Each option this slice does not serve raises at load, naming itself,
    and leaves the shard empty; the options served since (SERVED_NOW) load
    as what they ask for."""
    from dnet_tpu_torch.shard.compute import ShardCapabilityError
    from dnet_tpu_torch.shard.runtime import ShardRuntime

    rt = ShardRuntime("s", device="cpu")
    kwargs = dict(option)
    layers = kwargs.pop("layers", [0, 1])
    if _option_id(option) in SERVED_NOW:
        rt.load_model_core(str(tiny_llama_dir), layers, max_seq=MAX_SEQ, param_dtype="float32", **kwargs)
        c = rt.compute
        assert c.wire_pipeline == bool(option.get("wire_pipeline"))
        assert (c.lane_pool.slots if c.lane_pool else 0) == option.get("lanes", 0)
        assert (c.spec_lookahead, c._spec_ok) == (option.get("spec_lookahead", 0), "spec_lookahead" in option)
        assert (c.prefix_snaps.capacity if c.prefix_snaps is not None else 0) == option.get("prefix_cache", 0)
        assert c.rounds == ([[0], [2]] if "layers" in option else [[0, 1]])
        rt.unload_model_core()
        return
    with pytest.raises(ShardCapabilityError, match="does not serve"):
        rt.load_model_core(str(tiny_llama_dir), layers, max_seq=MAX_SEQ, param_dtype="float32", **kwargs)
    assert rt.compute is None


@pytest.mark.parametrize("option,plan", STREAMING, ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items())
                         if isinstance(o, dict) else o)
def test_streaming_load_options_serve(tiny_llama_dir, local_greedy, option, plan):
    """window_size / residency_size in the tail shard's load body: the plan
    is the reference's (`plan_policy`), and the ring's greedy stream equals
    the single process's."""
    from dnet_tpu.core.weights import plan_policy as ref_plan_policy

    port, _, rts = asyncio.run(_run_ring(tiny_llama_dir, prompts=PROMPTS[:1], shard_opts=({}, option)))
    engines = [rt.compute.engine for rt in rts]
    assert [e.plan.name for e in engines] == ["fit", plan] == ["fit", ref_plan_policy(2, **option).name]
    assert port == local_greedy[:1]


@pytest.mark.parametrize("weight_quant_bits", [8])
def test_weight_quant_load_option_serves(tiny_llama_dir, weight_quant_bits):
    """weight_quant_bits in the load body (once refused): each shard
    quantizes its layers (the tail its LM head too), and the ring's greedy
    stream equals the single process's at the same bits, and dnet_tpu's
    ring's."""
    from dnet_tpu_torch.ops.quant import is_quantized

    port, _, rts = asyncio.run(_run_ring(tiny_llama_dir, prompts=PROMPTS[:2], weight_quant_bits=weight_quant_bits))
    engines = [rt.compute.engine for rt in rts]
    assert [e.weight_quant_bits for e in engines] == [weight_quant_bits] * 2
    assert all(is_quantized(e.window_params[0]["w_up"]) for e in engines)
    assert port == _local_streams(tiny_llama_dir, prompts=PROMPTS[:2], weight_quant_bits=weight_quant_bits)
    ref, _, _ = asyncio.run(_run_ring(tiny_llama_dir, kinds=("ref", "ref"), api_kind="ref", prompts=PROMPTS[:2],
                                      weight_quant_bits=weight_quant_bits))
    assert port == ref


def test_wire_pipeline_env_is_refused(tiny_llama_dir, monkeypatch):
    """Refused until the wire pipeline was ported (the name is kept): the
    environment's DNET_WIRE_PIPELINE=1 now turns the shard's pipeline on,
    with DNET_WIRE_DEPTH slots, warmed at load."""
    from dnet_tpu_torch.shard.compute import ShardCompute

    monkeypatch.setenv("DNET_WIRE_PIPELINE", "1")
    monkeypatch.setenv("DNET_WIRE_DEPTH", "3")
    sc = ShardCompute(tiny_llama_dir, [0, 1], max_seq=MAX_SEQ, param_dtype="float32", device="cpu")
    assert sc.wire_pipeline and sc._encode_ring.depth == 3 and sc.wire_stats["warm_encodes"] == 1


def test_relay_and_stale_frames(tiny_llama_dir):
    """A frame for a layer this shard does not own relays to the next hop;
    a mid-stream frame with no session fails its request with an error
    token instead of computing."""
    from dnet_tpu_torch.core.types import DecodingParams as DP
    from dnet_tpu_torch.transport.protocol import ActivationFrame
    from dnet_tpu_torch.utils.serialization import tensor_to_bytes

    async def go():
        net = Net()
        rt, adapter = _port_shard(net, "s1")
        relayed = []

        async def sink(data):
            relayed.append(port_proto.ActivationFrame.from_bytes(data))
            return port_proto.StreamAck(nonce="r", seq=0).to_bytes()

        net.add_shard("s0", type("Sink", (), {"ingress_frame": None})(), port_proto)
        net.deliver = lambda addr, data: sink(data)
        tokens = []

        class Api:
            def resolve_token(self, r):
                tokens.append(r)

        net.api = (Api(), port_proto)
        loop = asyncio.get_running_loop()
        rt.start(loop)
        await adapter.start()
        await loop.run_in_executor(None, lambda: rt.load_model_core(
            str(tiny_llama_dir), [2, 3], max_seq=MAX_SEQ, param_dtype="float32"))
        adapter.configure_topology("s0")
        import numpy as np

        payload, dtype, shape = tensor_to_bytes(np.zeros((1, 1), np.int32))
        frame = ActivationFrame(nonce="r", seq=0, layer_id=-1, pos=0, dtype="tokens", shape=shape,
                                payload=payload, callback_url="grpc://api:1", decoding=dataclasses.asdict(DP()))
        assert await adapter.ingress_frame(frame) == (True, "relayed")
        assert [f.layer_id for f in relayed] == [-1]
        hidden, hdtype, hshape = tensor_to_bytes(np.zeros((1, 1, 64), np.float32))
        stale = dataclasses.replace(frame, layer_id=1, pos=5, dtype=hdtype, shape=hshape, payload=hidden)
        assert await adapter.ingress_frame(stale) == (True, "")
        for _ in range(200):
            if tokens:
                break
            await asyncio.sleep(0.01)
        await adapter.shutdown()
        rt.stop()
        return tokens

    tokens = asyncio.run(go())
    assert len(tokens) == 1 and tokens[0].token_id == -1 and "no session" in tokens[0].error
