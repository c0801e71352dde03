"""The overlapped wire pipeline (DNET_WIRE_PIPELINE=1) on the port, held to
the synchronous encode and to the reference's pipelined ring.

The reference's cases (tests/subsystems/test_wire_pipeline.py) that need
no jit, rebound onto the port: the launched encode's bytes equal the
synchronous encode's (and the reference's encoders') bit for bit; the
encode ring's depth bound and release, a discarded payload and a chaos
encode fault releasing their slot, a discard leaving an earlier encode's
staging buffers alone; a chaos decode fault NACKing a frame
at ingress; a broken stream re-sending the encoded frame with its seq; the
scheduler's tick dispatch resolving decode before prefill, and a
scheduler burst equal with and without the pipeline; and the acceptance
cases through both packages' whole API stacks over in-process two-shard
rings: lossless greedy SSE byte-identical to the reference's pipelined
ring and to the port's ring without the pipeline, and qsparse8 token
parity at the reference's tolerance.
"""

import asyncio
import re

import numpy as np
import pytest
import torch

from dnet_tpu.config import reset_settings_cache
from dnet_tpu_torch.obs import metric
from tests.torch_ring_harness import HttpRing

pytestmark = [pytest.mark.ring, pytest.mark.shard]

CHATS = ["Hi", "Hello there", "A quick brown"]


@pytest.fixture
def env(monkeypatch):
    """Set variables for both packages (the reference caches its settings)."""

    def set_env(values: dict):
        for k, v in values.items():
            monkeypatch.setenv(k, v)
        reset_settings_cache()

    yield set_env
    reset_settings_cache()


# ---- the codec's two halves ---------------------------------------------------

ENCODES = [  # (shape, drop_frac, wire dtype, quant bits, group size)
    ((1, 7, 64), 0.0, "bfloat16", 0, 64),
    ((1, 3, 128), 0.5, "bfloat16", 0, 64),
    ((2, 2, 128), 0.5, "float32", 8, 64),
    ((1, 4, 32), 0.5, "float32", 8, 64),
    ((3, 1, 256), 0.0, "bfloat16", 8, 64),
]


@pytest.mark.parametrize("case", ENCODES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-q{c[3]}")
def test_launch_encode_bytes_equal_the_synchronous_encode(case):
    """launch_encode + finalize (with the pipeline's staging) gives the
    synchronous encoders' bytes, dtype tag and shape; the lossless and
    sparse_v1 payloads are also the reference's bytes, and every payload
    decodes to the reference's values on both packages' decoders."""
    import dnet_tpu.compression as ref
    from dnet_tpu.utils.serialization import tensor_to_bytes as ref_tensor_to_bytes
    from dnet_tpu_torch.compression import (
        EncodeStaging,
        compress_tensor,
        decompress_tensor,
        launch_encode,
    )
    from dnet_tpu_torch.utils.serialization import tensor_to_bytes

    shape, frac, wire, qbits, gs = case
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    enc = launch_encode(torch.from_numpy(x), frac, wire_dtype=wire, quant_bits=qbits, group_size=gs,
                        staging=EncodeStaging(2))
    payload = enc.finalize()
    if frac <= 0 and qbits == 0:
        want = tensor_to_bytes(torch.from_numpy(x), wire)
        ref_want = ref_tensor_to_bytes(x, wire)
    else:
        want = compress_tensor(torch.from_numpy(x), frac, wire_dtype=wire, quant_bits=qbits, group_size=gs)
        ref_want = ref.compress_tensor(x, frac, wire_dtype=wire, quant_bits=qbits, group_size=gs)
    assert (payload, enc.dtype, enc.shape) == want
    assert (enc.dtype, tuple(enc.shape)) == (ref_want[1], tuple(ref_want[2]))
    if qbits == 0:
        assert payload == ref_want[0]
    else:  # the reference's eager scales may differ by an ulp: compare values
        got = decompress_tensor(payload, enc.dtype, enc.shape).float().numpy()
        np.testing.assert_allclose(got, np.asarray(ref.decompress_tensor(ref_want[0], *ref_want[1:]), np.float32),
                                   atol=1e-4)


def test_encode_ring_depth_bounds_and_release():
    from dnet_tpu_torch.transport.wire_pipeline import EncodeRing

    ring = EncodeRing(depth=2)
    assert (ring.acquire(), ring.acquire()) == (0, 1)
    assert ring.inflight == 2 and ring.peak == 2
    assert ring.acquire(max_wait_s=0.05) is None  # full: backpressure, no deadlock
    ring.release(1)
    assert ring.acquire(max_wait_s=0.05) == 1
    ring.release(0)
    ring.release(1)
    assert ring.inflight == 0 and ring.peak == 2
    with pytest.raises(ValueError):
        ring.release(0)  # not held


def test_encode_ring_slot_outlives_a_later_discard():
    """Launch A, launch B, discard B, launch C: C takes B's slot (its
    staging buffers), never A's, which A's finalize may still be reading."""
    from dnet_tpu_torch.transport.wire_pipeline import EncodeRing

    ring = EncodeRing(depth=2)
    a, b = ring.acquire(), ring.acquire()
    ring.release(b)  # B dropped before its send
    c = ring.acquire(max_wait_s=0.05)
    assert c == b and c != a
    ring.release(a)
    ring.release(c)


@pytest.mark.gpu
def test_discarded_encode_leaves_earlier_staging_alone():
    """On the card: encode A, then B, discard B, encode C through the same
    ring and staging; A's finalized bytes are still compress_tensor(A)'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dnet_tpu_torch.compression import EncodeStaging, compress_tensor, launch_encode
    from dnet_tpu_torch.transport.wire_pipeline import EncodeRing, PendingWirePayload

    ring, staging = EncodeRing(depth=2), EncodeStaging(2)
    xs = [torch.randn((1, 1, 256), device="cuda", generator=torch.Generator("cuda").manual_seed(i))
          for i in range(3)]

    def launch(x):
        slot = ring.acquire(max_wait_s=0.05)
        enc = launch_encode(x, 0.5, quant_bits=8, staging=staging, slot=slot)
        return PendingWirePayload(enc, ring=ring, slot=slot)

    a, b = launch(xs[0]), launch(xs[1])
    b.discard()
    c = launch(xs[2])
    assert a.finalize() == compress_tensor(xs[0], 0.5, quant_bits=8)[0]
    assert c.finalize() == compress_tensor(xs[2], 0.5, quant_bits=8)[0]
    assert ring.inflight == 0


def _pending(depth=1):
    from dnet_tpu_torch.compression import launch_encode
    from dnet_tpu_torch.transport.wire_pipeline import EncodeRing, PendingWirePayload

    ring = EncodeRing(depth=depth)
    slot = ring.acquire()
    return ring, PendingWirePayload(launch_encode(torch.zeros((1, 1, 8)), 0.0), ring=ring, slot=slot)


def test_pending_payload_discard_releases_slot():
    ring, pending = _pending()
    pending.discard()  # a frame dropped before its send
    assert ring.inflight == 0 and ring.acquire(max_wait_s=0.05) == 0


def test_chaos_wire_encode_error_still_releases_slot():
    from dnet_tpu_torch.resilience import chaos

    counter = metric("dnet_chaos_injected_total").labels(point="wire_encode")
    before = counter.value
    chaos.install_chaos("wire_encode:error_at:1")
    try:
        ring, pending = _pending()
        with pytest.raises(chaos.ChaosError):
            pending.finalize()
        assert ring.inflight == 0 and counter.value == before + 1
    finally:
        chaos.clear_chaos()


# ---- a shard under the pipeline ------------------------------------------------


async def _shard(model_dir, layers, ring_client_factory):
    from dnet_tpu_torch.shard.adapter import RingAdapter
    from dnet_tpu_torch.shard.runtime import ShardRuntime
    from tests.fakes.transport import FakeCallbackClient

    rt = ShardRuntime("s", device="cpu")
    adapter = RingAdapter(rt, ring_client_factory=ring_client_factory, callback_client_factory=FakeCallbackClient)
    loop = asyncio.get_running_loop()
    rt.start(loop)
    await adapter.start()
    await loop.run_in_executor(None, lambda: rt.load_model_core(str(model_dir), layers, max_seq=64,
                                                                param_dtype="float32"))
    return rt, adapter


def test_chaos_wire_decode_fails_frame_at_ingress(tiny_llama_dir, env):
    """A wire_decode fault at ingress (where the pipeline decodes a queued
    frame) NACKs the frame instead of queueing it for compute."""
    from dnet_tpu_torch.resilience import chaos
    from dnet_tpu_torch.transport.protocol import ActivationFrame
    from dnet_tpu_torch.utils.serialization import tensor_to_bytes
    from tests.fakes.transport import FakeRingClient

    env({"DNET_WIRE_PIPELINE": "1"})

    async def go():
        rt, adapter = await _shard(tiny_llama_dir, [2, 3], FakeRingClient)
        try:
            assert rt.compute.wire_pipeline
            payload, dtype, shape = tensor_to_bytes(np.zeros((1, 1, 64), np.float32), "bfloat16")
            frame = ActivationFrame(nonce="cz", seq=0, layer_id=1, pos=0, dtype=dtype, shape=shape, payload=payload)
            chaos.install_chaos("wire_decode:error_at:1")
            ok, msg = await adapter.ingress_frame(frame)
            assert not ok and "wire decode failed" in msg and rt.queue_depth == 0
        finally:
            chaos.clear_chaos()
            await adapter.shutdown()
            rt.stop()

    asyncio.run(go())


def test_stream_reopen_resends_encoded_frame_with_original_seq(tiny_llama_dir, env):
    """A one-token frame's hop goes out as a launched encode; the tx stage
    finalizes it before the first write, so the re-send after a broken
    stream carries the same bytes and seq, and the encode ring's slot is
    released."""
    from dnet_tpu.transport.protocol import StreamAck
    from dnet_tpu_torch.transport.protocol import ActivationFrame
    from tests.fakes.transport import FakeRingClient, FakeStreamCall

    env({"DNET_WIRE_PIPELINE": "1"})
    attempts = []

    class BreakOnceClient(FakeRingClient):
        def open_stream(self):
            async def deliver(frame):
                attempts.append(frame)
                if len(attempts) == 1:
                    raise ConnectionError("stream snapped mid-write")
                return StreamAck(nonce=frame.nonce, seq=frame.seq, ok=True)

            call = FakeStreamCall(deliver)
            self.streams.append(call)
            return call

    async def go():
        rt, adapter = await _shard(tiny_llama_dir, [0, 1], BreakOnceClient)
        adapter.configure_topology("next:1")
        try:
            ids = np.asarray([[5]], dtype=np.int32)
            frame = ActivationFrame(nonce="rs", seq=4, layer_id=-1, pos=0, dtype="tokens", shape=ids.shape,
                                    payload=ids.tobytes(), callback_url="grpc://api:1")
            ok, _ = await adapter.ingress_frame(frame)
            assert ok
            for _ in range(1500):
                if len(attempts) >= 2:
                    break
                await asyncio.sleep(0.01)
            first, second = attempts[:2]
            assert first.seq == second.seq == 4 and isinstance(second.payload, bytes)
            assert first.payload == second.payload and first.dtype == second.dtype == "bfloat16"
            ring = rt.compute._encode_ring
            assert ring.inflight == 0 and ring.peak == 1
            assert rt.compute.wire_stats["frames_encoded"] == 1
        finally:
            await adapter.shutdown()
            rt.stop()

    asyncio.run(go())


# ---- the scheduler's tick dispatch ---------------------------------------------


def test_execute_tick_dispatches_decode_before_prefill():
    from tests.test_torch_sched import FakeStepEngine, _chunk, _modules

    m = _modules("dnet_tpu_torch")
    order = []
    eng = FakeStepEngine(m)
    eng.occupy("dec", committed=4, blocks=1)
    real_prefill = eng.prefill_chunk

    def tracking_prefill(nonce, ids, seed=None):
        order.append(("prefill", nonce))
        return real_prefill(nonce, ids, seed)

    eng.prefill_chunk = tracking_prefill
    eng.reserve_slot("new")
    plan = m.policy.TickPlan()
    plan.decode = {"dec": (42, m.types.DecodingParams())}
    plan.steps = {"dec": 3}
    plan.prefills = [_chunk(m, "new")]
    res = m.step.execute_tick(eng, plan, on_decode=lambda n, s: order.append(("decode", n)))
    assert order[0] == ("decode", "dec") and ("prefill", "new") in order
    assert res.dispatched == ["dec"] and "dec" in res.decode_results


def test_sched_burst_with_the_pipeline_resolves_each_step_once(tiny_llama_dir, env, monkeypatch):
    """DNET_SCHED=1 on paged slots, prompts prefilled 8 tokens a tick and 16
    tokens a tick in all, so the burst's ticks mix prefill and decode: the
    same greedy texts with the pipeline on, its decode steps resolved
    early through the tick dispatch and never twice."""
    from dnet_tpu_torch.api.inference import InferenceManager
    from dnet_tpu_torch.api.model_manager import LocalModelManager
    from dnet_tpu_torch.api.schemas import ChatCompletionRequest
    from dnet_tpu_torch.sched.engine import SchedulerAdapter

    early = []
    real = SchedulerAdapter._dispatch_decode

    def spy(self, plan, nonce, sample):
        early.append(nonce)
        return real(self, plan, nonce, sample)

    monkeypatch.setattr(SchedulerAdapter, "_dispatch_decode", spy)

    async def burst():
        inference = InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=4)
        manager = LocalModelManager(inference, max_seq=64, param_dtype="float32", batch_slots=4, device="cpu")
        await manager.load_model(str(tiny_llama_dir))
        try:
            reqs = [ChatCompletionRequest.model_validate(
                {"model": "tiny", "messages": [{"role": "user", "content": p}], "max_tokens": 8, "temperature": 0})
                for p in ["Hi", "Hello there", "A quick brown fox", "tail prompt"]]
            outs = await asyncio.gather(*(inference.generate(r) for r in reqs))
            return [o.choices[0].message.content for o in outs]
        finally:
            await manager.unload_model()

    env({"DNET_SCHED": "1", "DNET_KV_PAGED": "1", "DNET_SCHED_PREFILL_CHUNK": "8", "DNET_SCHED_TOKEN_BUDGET": "16"})
    plain = asyncio.run(burst())
    assert not early
    env({"DNET_WIRE_PIPELINE": "1"})
    piped = asyncio.run(burst())
    assert piped == plain and early


# ---- acceptance: whole API stacks over in-process rings --------------------------


def _normalize(raw: str) -> str:
    raw = re.sub(r'"id": ?"[^"]*"', '"id": "X"', raw)
    return re.sub(r'"created": ?\d+', '"created": 0', raw)


def _ring(pkg: str, model_dir, stream=True, max_tokens=6) -> dict:
    async def go():
        ring = HttpRing(pkg, model_dir)
        try:
            status, text = await ring.start()
            assert status == 200, text
            out = [await ring.chat(c, max_tokens=max_tokens, stream=stream) for c in CHATS]
            computes = [ring.shards[n].runtime.compute for n in ("s0", "s1")]
            return {"out": out, "bytes": dict(ring.net.bytes_to), "pipeline": [c.wire_pipeline for c in computes],
                    "frames": getattr(computes[0], "wire_stats", {}).get("frames_encoded"),
                    "peak": getattr(computes[0]._encode_ring, "peak", None),
                    "codec": computes[0].wire_codec}
        finally:
            await ring.stop()

    return asyncio.run(go())


def test_pipeline_lossless_sse_byte_parity(tiny_llama_dir, env):
    """The lossless codec under the pipeline: greedy SSE byte-identical to
    the port's ring without it and to the reference's pipelined ring, the
    same hidden bytes on the wire, encodes observed and overlapped."""
    legacy = _ring("dnet_tpu_torch", tiny_llama_dir)
    env({"DNET_WIRE_PIPELINE": "1"})
    enc0 = metric("dnet_wire_encode_ms").count
    piped = _ring("dnet_tpu_torch", tiny_llama_dir)
    ref = _ring("dnet_tpu", tiny_llama_dir)
    assert legacy["pipeline"] == [False, False] and piped["pipeline"] == [True, True] == ref["pipeline"]
    norm = lambda r: [_normalize(text) for _, text in r["out"]]  # noqa: E731
    assert norm(piped) == norm(legacy) == norm(ref)
    for _, text in piped["out"]:
        events = [ln for ln in text.splitlines() if ln.startswith("data: ")]
        assert events[-1] == "data: [DONE]" and len(events) > 2
    assert piped["bytes"] == legacy["bytes"] == ref["bytes"]
    assert metric("dnet_wire_encode_ms").count > enc0 and metric("dnet_wire_overlap_ratio").value > 0
    assert 1 <= piped["peak"] <= 2


def test_pipeline_qsparse8_token_parity_tolerance(tiny_llama_dir, env):
    """qsparse8 under the pipeline at pct 0 (int8 over every column): every
    request completes, at least 2 of 3 texts equal the lossless ring's (the
    reference's tolerance), in as many hidden frames at fewer bytes."""
    env({"DNET_WIRE_PIPELINE": "1", "DNET_WIRE_QSPARSE_PCT": "0.0", "DNET_WIRE_CODEC": "lossless"})
    lossless = _ring("dnet_tpu_torch", tiny_llama_dir, stream=False, max_tokens=8)
    env({"DNET_WIRE_CODEC": "qsparse8"})
    q8 = _ring("dnet_tpu_torch", tiny_llama_dir, stream=False, max_tokens=8)
    assert q8["codec"] == "qsparse8" and all(status == 200 for status, _ in q8["out"])
    assert sum(a == b for a, b in zip(q8["out"], lossless["out"])) >= 2, (q8["out"], lossless["out"])
    key = "127.0.0.1:2"  # s0 -> s1
    assert q8["bytes"][key] < lossless["bytes"][key] and q8["frames"] == lossless["frames"]
