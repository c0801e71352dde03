"""The in-process, byte-crossing ring harness of the port's ring tests: an
API adapter and two shards wired through fake ring clients that pass the
packed frame, ACK and token bytes across, so either package's node can
sit at either end of a hop (`_run_ring`), and the port's single-process
greedy streams to hold a ring against (`_local_streams`).
"""

import asyncio

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

    def add_shard(self, addr, adapter, proto):
        self.nodes[addr] = (adapter, proto)

    async def deliver(self, addr, data: bytes) -> bytes:
        adapter, proto = self.nodes[addr]
        frame = proto.ActivationFrame.from_bytes(data)
        if frame.dtype == "tokens":
            self.token_frames.append((addr, frame.seq, frame.auto_steps))
        else:
            self.bytes_to[addr] = self.bytes_to.get(addr, 0) + len(frame.payload)
        ok, msg = await adapter.ingress_frame(frame)
        return proto.StreamAck(nonce=frame.nonce, seq=frame.seq, ok=ok,
                               backpressure=msg == "backpressure", message=msg).to_bytes()

    def ring_client(self, sender_proto):
        net = self

        class Client:
            def __init__(self, addr):
                self.addr = addr

            def open_stream(self):
                return BytesStreamCall(lambda b: net.deliver(self.addr, b), sender_proto.StreamAck)

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
    adapter = RingAdapter(rt, ring_client_factory=net.ring_client(port_proto),
                          callback_client_factory=net.callback_client(port_proto))
    net.add_shard(name, adapter, port_proto)
    return rt, adapter


def _ref_shard(net, name):
    from dnet_tpu.shard.adapter import RingAdapter
    from dnet_tpu.shard.runtime import ShardRuntime

    rt = ShardRuntime(name)
    adapter = RingAdapter(rt, ring_client_factory=net.ring_client(ref_proto),
                          callback_client_factory=net.callback_client(ref_proto))
    net.add_shard(name, adapter, ref_proto)
    return rt, adapter


def _api(net, kind, auto_steps):
    if kind == "port":
        from dnet_tpu_torch.api.ring import RingApiAdapter

        proto = port_proto
    else:
        from dnet_tpu.api.ring import RingApiAdapter

        proto = ref_proto
    api = RingApiAdapter(head_addr="s0", callback_url="grpc://api:1", shard_grpc_addrs=["s0", "s1"],
                         ring_client_factory=net.ring_client(proto), max_seq_len=MAX_SEQ,
                         auto_steps=auto_steps)
    net.api = (api, proto)
    return api


async def _run_ring(model_dir, kinds=("port", "port"), api_kind="port", auto_steps=16, codec="lossless",
                    prompts=PROMPTS, steps=STEPS, decoding=None, kv_bits=0, weight_quant_bits=0,
                    shard_opts=({}, {}), split=SPLIT):
    """Serve each prompt for `steps` tokens through a two-shard ring of the
    given kinds over the layer ranges `split` (`shard_opts`: each shard's
    extra load options); returns (streams, net, shard runtimes)."""
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
        api = _api(net, api_kind, auto_steps)
        await api.start()
        streams = []
        dec = decoding or DecodingParams(temperature=0.0)
        try:
            for i, prompt in enumerate(prompts):
                nonce = f"r{i}"
                await api.reset_cache(nonce)
                got, send = [], list(prompt)
                for step in range(steps):
                    await api.send_tokens(nonce, send, dec, step, budget=steps - step)
                    res = await api.await_token(nonce, step, timeout=60.0)
                    assert not res.error, res.error
                    got.append(res.token_id)
                    send = [res.token_id]
                await api.reset_cache(nonce)
                streams.append(got)
        finally:
            await api.shutdown()
        return streams, net, [rt for rt, _ in nodes]
    finally:
        for rt, adapter in nodes:
            await adapter.shutdown()
            rt.stop()


def _local_streams(model_dir, decoding=None, prompts=PROMPTS, steps=STEPS, kv_bits=0, weight_quant_bits=0):
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.kvcache import resolve_kv_bits

    kv_dtype, kv_quant_bits = resolve_kv_bits(kv_bits)
    eng = LocalEngine(model_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", kv_dtype=kv_dtype,
                      kv_quant_bits=kv_quant_bits, weight_quant_bits=weight_quant_bits)
    dec = decoding or DecodingParams(temperature=0.0)
    return [[r.token_id for r in eng.generate(p, dec, max_tokens=steps, nonce=f"l{i}")]
            for i, p in enumerate(prompts)]
