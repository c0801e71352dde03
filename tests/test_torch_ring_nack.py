"""A shard's stale-epoch NACK on a port ring, held to the reference.

- The NACK: a ring API adapter at epoch N sends a token frame to a shard
  fenced at N + 1.  The shard refuses it (`stale epoch: ...`), and the
  adapter's `on_nack` hook fails the awaiting step at once with `frame
  rejected: stale epoch ...`, on both packages, instead of leaving it to
  wait out its timeout.
- The rejoin flap: both packages' ring managers, resume controllers and
  adapters over two in-process shards (HTTP control plane on local test
  servers, frames through the byte-crossing fake gRPC of
  tests/torch_ring_harness.py).  With DNET_RESILIENCE_RESUME=1 a greedy
  request decodes on epoch 4 (s1 alone); its step-4 frame meets s1 just
  after a delta update moved it to epoch 5 (s0 still quarantined), and its
  first replay meets the ring just after epoch 6 placed both shards.  A
  stub failure monitor reads degraded while a topology install is in
  flight, so each replay goes to the adapter of the install that fenced
  the last one.  Each package's request must end the same way, within the
  resume budget and far inside its token timeout: resumed, with the text
  of a clean request on the final ring."""

import asyncio
import importlib
import time
import types

import pytest

from dnet_tpu.config import reset_settings_cache
from tests.torch_ring_harness import MAX_SEQ, HttpRing, Net

pytestmark = [pytest.mark.api, pytest.mark.ring]

TOKEN_TIMEOUT_S = 20.0  # the request's token timeout: a step left to it would take this long


def _pkg(name: str) -> types.SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, proto=mod("transport.protocol"), ring=mod("api.ring"), types=mod("core.types"),
        runtime=mod("shard.runtime"), adapter=mod("shard.adapter"), ring_manager=mod("api.ring_manager"),
        schemas=mod("api.schemas"),
    )


def _runtime(p, name):
    return p.runtime.ShardRuntime(name, device="cpu") if p.name == "dnet_tpu_torch" else p.runtime.ShardRuntime(name)


# ---- the NACK ------------------------------------------------------------------


def _nack_outcome(name: str) -> tuple:
    """(error, seconds) of package `name`'s adapter at epoch 3 awaiting a
    frame its shard, fenced at epoch 4, refused."""
    p = _pkg(name)

    async def go():
        net = Net()
        rt = _runtime(p, "s0")
        rt.set_epoch(4)
        adapter = p.adapter.RingAdapter(rt, ring_client_factory=net.ring_client(p.proto),
                                        callback_client_factory=net.callback_client(p.proto))
        net.add_shard("s0", adapter, p.proto)
        rt.start(asyncio.get_running_loop())
        await adapter.start()
        api = p.ring.RingApiAdapter(head_addr="s0", callback_url="grpc://api:1", shard_grpc_addrs=["s0"],
                                    ring_client_factory=net.ring_client(p.proto), max_seq_len=MAX_SEQ, epoch=3)
        net.api = (api, p.proto)
        await api.start()
        try:
            t0 = time.monotonic()
            await api.send_tokens("n", [256, 72, 105], p.types.DecodingParams(temperature=0.0), 0, budget=4)
            try:
                res = await api.await_token("n", 0, timeout=TOKEN_TIMEOUT_S / 4)
            except asyncio.TimeoutError:
                return "timed out", time.monotonic() - t0
            return res.error, time.monotonic() - t0
        finally:
            await api.shutdown()
            await adapter.shutdown()
            rt.stop()

    return asyncio.run(go())


def test_stale_epoch_nack_fails_the_step_at_once():
    ref = _nack_outcome("dnet_tpu")
    port = _nack_outcome("dnet_tpu_torch")
    want = "frame rejected: stale epoch: frame carries epoch 3, holder is at epoch 4"
    assert ref[0] == port[0] == want
    assert ref[1] < 1.0 and port[1] < 1.0


# ---- the rejoin flap ---------------------------------------------------------


class InstallGate:
    """A failure monitor that reads degraded while a topology install is in
    flight: the replay waits for the install's new adapter."""

    def __init__(self):
        self.installs = []

    @property
    def degraded(self) -> bool:
        return any(not t.done() for t in self.installs)

    def down_shards(self):
        return []


class FlapNet(Net):
    """Runs `hooks[(nonce, seq)]` (once) before delivering that API token
    frame, and sets `after` 50 ms after the delivery."""

    def __init__(self):
        super().__init__()
        self.hooks = {}
        self.after = asyncio.Event()

    async def deliver(self, addr, data: bytes) -> bytes:
        frame = self.nodes[addr][1].ActivationFrame.from_bytes(data)
        hook = self.hooks.pop((frame.nonce, frame.seq), None) if frame.layer_id == -1 else None
        if hook is None:
            return await super().deliver(addr, data)
        await hook()
        try:
            return await super().deliver(addr, data)
        finally:
            asyncio.get_running_loop().call_later(0.05, self.after.set)


def _flap(name: str, model_dir, monkeypatch) -> dict:
    p = _pkg(name)
    monkeypatch.setenv("DNET_API_RING_AUTO_STEPS", "0")  # one API frame a step
    reset_settings_cache()

    async def go():
        net = FlapNet()
        ring, gate = HttpRing(name, model_dir, net, request_timeout_s=TOKEN_TIMEOUT_S), InstallGate()
        # an install's new adapter starts (and replaces the old one) only
        # once the fenced frame has been delivered and its step is awaited
        net.after.set()
        real_start = p.ring.RingApiAdapter.start

        async def start(self):
            await net.after.wait()
            return await real_start(self)

        monkeypatch.setattr(p.ring.RingApiAdapter, "start", start)
        await ring.setup()
        ring.inference.failure_monitor = gate
        ring.cluster.epoch_clock.observe(3)

        async def install(assignments):
            topo = p.ring_manager.build_manual_topology(str(model_dir), 4, assignments, ring.devices)
            ring.cluster.install_topology(topo)
            await ring.manager.load_model(str(model_dir), delta=True)

        def epochs():
            return {n: s.runtime.epoch for n, s in ring.shards.items()}

        async def flip(assignments, want: dict):
            """Start an install and return once every shard it places holds
            its epoch: the install's API half (the new adapter) waits for the
            fenced frame's delivery."""
            net.after.clear()
            gate.installs.append(asyncio.ensure_future(install(assignments)))
            while any(epochs()[n] != e for n, e in want.items()):
                assert not gate.installs[-1].done() or gate.installs[-1].exception() is None
                await asyncio.sleep(0.005)

        alone = [{"instance": "s1", "layers": [0, 1, 2, 3]}]
        both = [{"instance": "s0", "layers": [0, 1]}, {"instance": "s1", "layers": [2, 3]}]
        req = p.schemas.ChatCompletionRequest.model_validate(
            {"model": str(model_dir), "messages": [{"role": "user", "content": "A quick brown fox"}],
             "max_tokens": 12, "temperature": 0})
        try:
            await install(alone)  # epoch 4: s1 alone
            adapter, rid = ring.inference.adapter, {}
            real_reset = adapter.reset_cache

            async def reset(nonce):
                """The request's first reset names its rid: arm the flap."""
                if not rid:
                    rid["n"] = nonce
                    # the step-4 frame meets s1 just after a delta update
                    ring.net.hooks[(nonce, 4)] = lambda: flip(alone, {"s1": 5})
                    # the first replay meets the ring just after epoch 6
                    ring.net.hooks[(f"{nonce}#r1", 0)] = lambda: flip(both, {"s0": 6, "s1": 6})
                return await real_reset(nonce)

            adapter.reset_cache = reset
            t0 = time.monotonic()
            try:
                out = await ring.inference.generate(req)
                end = ("ok", out.choices[0].message.content, out.choices[0].finish_reason)
            except Exception as exc:  # noqa: BLE001 - the raised error is the outcome
                end = ("raised", type(exc).__name__, str(exc))
            took = time.monotonic() - t0
            await asyncio.gather(*gate.installs)
            clean = await ring.inference.generate(req)
            return {"end": end, "seconds": took, "epochs": epochs(), "epoch": ring.cluster.current_topology.epoch,
                    "clean": clean.choices[0].message.content}
        finally:
            await ring.stop()

    try:
        return asyncio.run(go())
    finally:
        reset_settings_cache()


def test_rejoin_flap_resumes_as_the_reference(tiny_llama_dir, monkeypatch):
    for k, v in {"DNET_RESILIENCE_RESUME": "1", "DNET_RESILIENCE_RESUME_DEADLINE_S": "10",
                 "DNET_RESILIENCE_MAX_RESUMES": "2"}.items():
        monkeypatch.setenv(k, v)
    ref = _flap("dnet_tpu", tiny_llama_dir, monkeypatch)
    port = _flap("dnet_tpu_torch", tiny_llama_dir, monkeypatch)
    assert port["end"] == ref["end"], (port, ref)
    assert port["end"][0] == "ok" and port["end"][1] == port["clean"], port
    assert port["epochs"] == {"s0": 6, "s1": 6} and port["epoch"] == 6
    # ended within the resume budget, far inside one token timeout
    assert port["seconds"] < TOKEN_TIMEOUT_S / 2 and ref["seconds"] < TOKEN_TIMEOUT_S / 2, (port, ref)
