"""Ring wire protocol: msgpack-framed messages over gRPC generic methods.

Counterpart of dnet_tpu/transport/protocol.py with the same method paths,
message fields and msgpack encoding, so a frame packed by either package
unpacks in the other field for field.  `payload` fields are raw
little-endian tensor bytes described by (dtype, shape), as in
utils/serialization.py.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import List, Optional, Tuple

import msgpack

from dnet_tpu_torch.core.types import ActivationMessage, DecodingParams, TokenResult

# gRPC method paths
RING_SERVICE = "dnet.DnetRing"
M_STREAM_ACTIVATIONS = f"/{RING_SERVICE}/StreamActivations"
M_HEALTH_CHECK = f"/{RING_SERVICE}/HealthCheck"
M_RESET_CACHE = f"/{RING_SERVICE}/ResetCache"
M_MEASURE_LATENCY = f"/{RING_SERVICE}/MeasureLatency"

API_SERVICE = "dnet.ShardApi"
M_SEND_TOKEN = f"/{API_SERVICE}/SendToken"


def pack(obj: dict) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def unpack(data: bytes) -> dict:
    # strict_map_key off: DecodingParams.logit_bias rides the wire with
    # integer token-id keys
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


class _Packed:
    """to_bytes / from_bytes over the dataclass's fields."""

    def to_bytes(self) -> bytes:
        return pack(asdict(self))

    @classmethod
    def from_bytes(cls, data: bytes):
        return cls(**unpack(data))


@dataclass
class ActivationFrame:
    """One hop of the ring: token injection, hidden state, or relay."""

    nonce: str
    seq: int
    layer_id: int  # last layer applied; -1 = raw tokens entering layer 0
    pos: int  # absolute sequence offset of this frame's first token
    dtype: str  # "tokens" | wire dtype name (may carry the codec's tags)
    shape: Tuple[int, ...]
    payload: bytes
    callback_url: str = ""  # grpc://host:port for the final token
    decoding: dict = field(default_factory=dict)
    t_sent: float = 0.0
    t_sent_mono: float = 0.0
    auto_steps: int = 0  # decode grant: tokens the tail may self-continue
    drafts: List[int] = field(default_factory=list)
    committed: List[int] = field(default_factory=list)
    lanes: List[dict] = field(default_factory=list)
    prefix_store: str = ""
    prefix_hit: str = ""
    deadline: float = 0.0  # sender's wall clock, epoch seconds; 0 = none
    epoch: int = 0  # topology epoch; 0 = unfenced
    codec: str = ""  # hop-codec name (compression.wire.codec_name)

    def to_bytes(self) -> bytes:
        d = asdict(self)
        d["shape"] = list(self.shape)
        return pack(d)

    @classmethod
    def from_bytes(cls, data: bytes) -> "ActivationFrame":
        d = unpack(data)
        d["shape"] = tuple(d["shape"])
        return cls(**d)

    def to_message(self) -> ActivationMessage:
        dec = DecodingParams(**self.decoding) if self.decoding else DecodingParams()
        return ActivationMessage(
            nonce=self.nonce,
            layer_id=self.layer_id,
            seq=self.seq,
            dtype=self.dtype,
            shape=self.shape,
            data=self.payload,
            pos=self.pos,
            callback_url=self.callback_url,
            decoding=dec,
            auto_steps=self.auto_steps,
            drafts=list(self.drafts),
            committed=list(self.committed),
            lanes=list(self.lanes),
            prefix_store=self.prefix_store,
            prefix_hit=self.prefix_hit,
            deadline=self.deadline,
            epoch=self.epoch,
        )


@dataclass
class StreamAck(_Packed):
    nonce: str
    seq: int
    ok: bool = True
    backpressure: bool = False
    message: str = ""


@dataclass
class TokenPayload(_Packed):
    """Last shard -> API: the sampled token."""

    nonce: str
    step: int
    token_id: int
    logprob: Optional[float] = None
    top_ids: List[int] = field(default_factory=list)
    top_logprobs: List[float] = field(default_factory=list)
    error: str = ""
    epoch: int = 0

    def to_result(self) -> TokenResult:
        top = list(zip(self.top_ids, self.top_logprobs)) if self.top_ids else None
        return TokenResult(
            nonce=self.nonce,
            token_id=self.token_id,
            logprob=self.logprob,
            top_logprobs=top,
            step=self.step,
            error=self.error,
            epoch=self.epoch,
        )


@dataclass
class HealthInfo(_Packed):
    ok: bool = True
    model: str = ""
    layers: List[int] = field(default_factory=list)
    queue_depth: int = 0
    epoch: int = 0


@dataclass
class ResetCacheRequest(_Packed):
    nonce: str = ""  # empty = reset all
    epoch: int = 0


@dataclass
class Empty(_Packed):
    ok: bool = True


@dataclass
class LatencyProbe(_Packed):
    """Echo RPC for link profiling: the echo stamps `t_remote` (the
    server's wall clock while serving), so one probe is also a clock-offset
    sample (obs/clock.py)."""

    t_sent: float
    payload: bytes = b""
    t_remote: float = 0.0
