"""The in-process, byte-crossing ring harness of the port's ring tests: an
API adapter and two shards wired through fake ring clients that pass the
packed frame, ACK and token bytes across, so either package's node can
sit at either end of a hop (`_run_ring`); either package's whole API stack
(ring manager, cluster manager, HTTP server) over two of its shards whose
control planes run on local test servers (`HttpRing`); and the port's
single-process greedy streams to hold a ring against (`_local_streams`).
"""

import asyncio
import importlib

import dnet_tpu.transport.protocol as ref_proto
import dnet_tpu_torch.transport.protocol as port_proto
from dnet_tpu_torch.core.types import DecodingParams

MAX_SEQ = 64
PROMPTS = [[256, 72, 105], [256, 87, 104, 121, 32, 110, 111, 116, 63], [256, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]]
STEPS = 8
SPLIT = ([0, 1], [2, 3])


class BytesStreamCall:
    """A gRPC stream-stream call: each frame crosses as its packed bytes
    and its ACK comes back as bytes, unpacked by the sender's package."""

    def __init__(self, deliver, ack_cls):
        self.deliver, self.ack_cls = deliver, ack_cls
        self.acks = asyncio.Queue()

    async def write(self, frame):
        await self.acks.put(self.ack_cls.from_bytes(await self.deliver(frame.to_bytes())))

    async def read(self):
        return await self.acks.get()

    async def done_writing(self):
        pass


class Net:
    """addr -> node; the ring and callback clients of either package."""

    def __init__(self):
        self.nodes = {}  # addr -> (adapter, protocol module of the receiver)
        self.api = None  # (api adapter, its protocol module)
        self.bytes_to = {}  # addr -> hidden payload bytes received
        self.token_frames = []  # (addr, seq, auto_steps) of every token frame
        self.continuations = []  # (sender, seq) of every token frame a shard sent (a tail's continuation)
        self.hold = {}  # (addr, nonce, seq) -> asyncio.Event a frame's delivery waits for

    def add_shard(self, addr, adapter, proto):
        self.nodes[addr] = (adapter, proto)

    async def send(self, sender: str, sender_proto, addr, data: bytes) -> bytes:
        """A frame from `sender` (a shard's name, or "" for the API) to
        `addr`."""
        if sender:
            frame = sender_proto.ActivationFrame.from_bytes(data)
            if frame.dtype == "tokens":
                self.continuations.append((sender, frame.seq))
        return await self.deliver(addr, data)

    async def deliver(self, addr, data: bytes) -> bytes:
        adapter, proto = self.nodes[addr]
        frame = proto.ActivationFrame.from_bytes(data)
        gate = self.hold.get((addr, frame.nonce, frame.seq))
        if gate is not None:
            await gate.wait()
        if frame.dtype == "tokens":
            self.token_frames.append((addr, frame.seq, frame.auto_steps))
        else:
            self.bytes_to[addr] = self.bytes_to.get(addr, 0) + len(frame.payload)
        ok, msg = await adapter.ingress_frame(frame)
        return proto.StreamAck(nonce=frame.nonce, seq=frame.seq, ok=ok,
                               backpressure=msg == "backpressure", message=msg).to_bytes()

    def ring_client(self, sender_proto, sender: str = ""):
        """A ring client class of the sender's package; `sender` names a
        shard (the API's clients have none)."""
        net = self

        class Client:
            def __init__(self, addr):
                self.addr = addr

            def open_stream(self):
                return BytesStreamCall(lambda b: net.send(sender, sender_proto, self.addr, b), sender_proto.StreamAck)

            async def reset_cache(self, nonce="", timeout=10.0, epoch=0):
                await net.nodes[self.addr][0].reset_cache(nonce)
                return sender_proto.Empty()

            async def close(self):
                pass

        return Client

    def callback_client(self, sender_proto):
        net = self

        class Client:
            def __init__(self, addr):
                self.addr = addr

            async def send_token(self, payload, timeout=3.0):
                api, proto = net.api
                api.resolve_token(proto.TokenPayload.from_bytes(payload.to_bytes()).to_result())
                return sender_proto.Empty()

            async def close(self):
                pass

        return Client


def _port_shard(net, name):
    from dnet_tpu_torch.shard.adapter import RingAdapter
    from dnet_tpu_torch.shard.runtime import ShardRuntime

    rt = ShardRuntime(name, device="cpu")
    adapter = RingAdapter(rt, ring_client_factory=net.ring_client(port_proto, sender=name),
                          callback_client_factory=net.callback_client(port_proto))
    net.add_shard(name, adapter, port_proto)
    return rt, adapter


def _ref_shard(net, name):
    from dnet_tpu.shard.adapter import RingAdapter
    from dnet_tpu.shard.runtime import ShardRuntime

    rt = ShardRuntime(name)
    adapter = RingAdapter(rt, ring_client_factory=net.ring_client(ref_proto, sender=name),
                          callback_client_factory=net.callback_client(ref_proto))
    net.add_shard(name, adapter, ref_proto)
    return rt, adapter


def _api(net, kind, auto_steps, prefix_cache=0, max_seq=MAX_SEQ):
    if kind == "port":
        from dnet_tpu_torch.api.ring import RingApiAdapter

        proto = port_proto
    else:
        from dnet_tpu.api.ring import RingApiAdapter

        proto = ref_proto
    api = RingApiAdapter(head_addr="s0", callback_url="grpc://api:1", shard_grpc_addrs=["s0", "s1"],
                         ring_client_factory=net.ring_client(proto), max_seq_len=max_seq,
                         auto_steps=auto_steps, prefix_cache=prefix_cache)
    net.api = (api, proto)
    return api


async def _run_ring(model_dir, kinds=("port", "port"), api_kind="port", auto_steps=16, codec="lossless",
                    prompts=PROMPTS, steps=STEPS, decoding=None, kv_bits=0, weight_quant_bits=0,
                    shard_opts=({}, {}), split=SPLIT, prefix_cache=0, drive=None):
    """Serve each prompt for `steps` tokens through a two-shard ring of the
    given kinds over the layer ranges `split` (`shard_opts`: each shard's
    extra load options; `prefix_cache`: the API adapter's), or, with
    `drive`, whatever `await drive(api, net, shard runtimes)` serves;
    returns (streams, net, shard runtimes)."""
    net = Net()
    make = {"port": _port_shard, "ref": _ref_shard}
    nodes = [make[k](net, f"s{i}") for i, k in enumerate(kinds)]
    loop = asyncio.get_running_loop()
    for rt, adapter in nodes:
        rt.start(loop)
        await adapter.start()
    try:
        await asyncio.gather(*(
            loop.run_in_executor(None, lambda rt=rt, ls=ls, opts=opts: rt.load_model_core(
                str(model_dir), ls, max_seq=MAX_SEQ, param_dtype="float32", wire_codec=codec,
                kv_bits=kv_bits, weight_quant_bits=weight_quant_bits, **opts))
            for (rt, _), ls, opts in zip(nodes, split, shard_opts)
        ))
        nodes[0][1].configure_topology("s1")
        nodes[1][1].configure_topology("s0")  # the tail's next is the head
        api = _api(net, api_kind, auto_steps, prefix_cache)
        await api.start()
        dec = decoding or DecodingParams(temperature=0.0)
        try:
            if drive is not None:
                streams = await drive(api, net, [rt for rt, _ in nodes])
            else:
                streams = [await _serve(api, f"r{i}", prompt, steps, dec) for i, prompt in enumerate(prompts)]
        finally:
            await api.shutdown()
        return streams, net, [rt for rt, _ in nodes]
    finally:
        for rt, adapter in nodes:
            await adapter.shutdown()
            rt.stop()


async def _serve(api, nonce, prompt, steps, dec):
    """One request through an API adapter: the prompt, then each sampled
    token fed back, `steps` tokens in all (the nonce reset before and
    after)."""
    await api.reset_cache(nonce)
    got, send = [], list(prompt)
    for step in range(steps):
        await api.send_tokens(nonce, send, dec, step, budget=steps - step)
        res = await api.await_token(nonce, step, timeout=60.0)
        assert not res.error, res.error
        got.append(res.token_id)
        send = [res.token_id]
    await api.reset_cache(nonce)
    return got


def _local_streams(model_dir, decoding=None, prompts=PROMPTS, steps=STEPS, kv_bits=0, weight_quant_bits=0):
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.kvcache import resolve_kv_bits

    kv_dtype, kv_quant_bits = resolve_kv_bits(kv_bits)
    eng = LocalEngine(model_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", kv_dtype=kv_dtype,
                      kv_quant_bits=kv_quant_bits, weight_quant_bits=weight_quant_bits)
    dec = decoding or DecodingParams(temperature=0.0)
    return [[r.token_id for r in eng.generate(p, dec, max_tokens=steps, nonce=f"l{i}")]
            for i, p in enumerate(prompts)]


class _Peers:
    def __init__(self, devices):
        self.devices = devices

    def peers(self):
        return self.devices


class HttpRing:
    """Package `pkg`'s API stack over two of its shards (s0, s1): each
    shard's HTTP control plane on a local test server, the frames through
    `net` (at "127.0.0.1:1" and ":2"), token callbacks to the API's current
    adapter, and the API's HTTP server behind `client`.  `start` prepares
    the manual topology `split` and loads `model_dir` through the API, as an
    operator would, so the ring manager ships the environment's settings."""

    def __init__(self, pkg: str, model_dir, net=None, request_timeout_s: float = 60.0):
        self.pkg, self.model_dir = pkg, str(model_dir)
        self.net = net if net is not None else Net()
        self.request_timeout_s = request_timeout_s
        self.mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
        self.proto = self.mod("transport.protocol")
        self.shards, self.servers, self.devices = {}, [], []
        self.client = None

    async def setup(self):
        """The shards, their servers and the API stack, with no topology."""
        from aiohttp.test_utils import TestClient, TestServer

        mod, proto, net = self.mod, self.proto, self.net
        self.inference = mod("api.inference").InferenceManager(adapter=None,
                                                                request_timeout_s=self.request_timeout_s)
        inference = self.inference

        class Callback:  # the API's token servicer: tokens go to the current adapter
            def __init__(self, addr):
                pass

            async def send_token(self, payload, timeout=3.0):
                inference.adapter.resolve_token(proto.TokenPayload.from_bytes(payload.to_bytes()).to_result())
                return proto.Empty()

            async def close(self):
                pass

        for i, name in enumerate(("s0", "s1")):
            runtime = mod("shard.runtime")
            rt = runtime.ShardRuntime(name, device="cpu") if self.pkg == "dnet_tpu_torch" else runtime.ShardRuntime(name)
            adapter = mod("shard.adapter").RingAdapter(rt, ring_client_factory=net.ring_client(proto),
                                                       callback_client_factory=Callback)
            shard = mod("shard.server").Shard(name, rt, adapter)
            await shard.start()
            srv = TestServer(mod("shard.http").ShardHTTPServer(shard).app)
            await srv.start_server()
            net.add_shard(f"127.0.0.1:{i + 1}", adapter, proto)
            self.shards[name] = shard
            self.servers.append(srv)
            self.devices.append(mod("core.types").DeviceInfo(instance=name, host="127.0.0.1", http_port=srv.port,
                                                             grpc_port=i + 1))
        self.cluster = mod("api.cluster").ClusterManager(_Peers(self.devices))
        self.manager = mod("api.ring_manager").RingModelManager(
            inference, self.cluster, api_callback_addr="127.0.0.1:9", max_seq=MAX_SEQ, param_dtype="float32",
            request_timeout_s=self.request_timeout_s, ring_client_factory=net.ring_client(proto))
        app = mod("api.http").ApiHTTPServer(inference, self.manager, self.cluster).app
        self.client = TestClient(TestServer(app))
        await self.client.start_server()

    async def start(self, split=SPLIT):
        await self.setup()
        assignments = [{"instance": f"s{i}", "layers": ls} for i, ls in enumerate(split) if ls]
        r = await self.client.post("/v1/prepare_topology_manual",
                                   json={"model": self.model_dir, "assignments": assignments})
        assert r.status == 200, await r.text()
        r = await self.client.post("/v1/load_model", json={"model": self.model_dir})
        return r.status, await r.text()

    async def chat(self, content: str, max_tokens: int = 8, stream: bool = True, **extra):
        """(status, the raw SSE text or the JSON body's text) of one chat."""
        r = await self.client.post("/v1/chat/completions", json={
            "model": self.model_dir, "messages": [{"role": "user", "content": content}],
            "max_tokens": max_tokens, "temperature": 0, "stream": stream, **extra})
        if stream:
            return r.status, (await r.read()).decode()
        body = await r.json()
        return r.status, body["choices"][0]["message"]["content"] if r.status == 200 else body

    async def stop(self):
        if self.client is not None:
            await self.client.close()
        if self.inference.adapter is not None:
            await self.inference.adapter.shutdown()
        for srv in self.servers:
            await srv.close()
        for shard in self.shards.values():
            await shard.stop()
            if shard.runtime.compute is not None:
                shard.runtime.compute.engine.close()
                shard.runtime.compute = None
