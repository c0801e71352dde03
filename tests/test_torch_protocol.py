"""The ring's wire protocol and tensor bytes against dnet_tpu's: a frame,
ACK or token payload packed by either package unpacks in the other field
for field, and a tensor serializes to the same bytes, dtype name and shape.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import dnet_tpu.transport.protocol as ref
import dnet_tpu.utils.serialization as ref_ser
import dnet_tpu_torch.transport.protocol as port
import dnet_tpu_torch.utils.serialization as ser
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.types import DecodingParams

pytestmark = pytest.mark.core

FULL_FRAME = dict(
    nonce="chatcmpl-1", seq=7, layer_id=7, pos=31, dtype="bfloat16|fmt=qsparse8_v1|pct=0.5|orig=2048|gs=64",
    shape=(1, 3, 2048), payload=bytes(range(256)) * 3, callback_url="grpc://10.0.0.1:58080",
    decoding=dataclasses.asdict(DecodingParams(temperature=0.8, top_p=0.9, seed=5, logit_bias={65: 3.5},
                                               stop_token_ids=(2, 7), logprobs=True, top_logprobs=3)),
    t_sent=1.5, t_sent_mono=2.5, auto_steps=15, drafts=[4, 5], committed=[6], lanes=[{"nonce": "a", "seq": 1}],
    prefix_store="abc", prefix_hit="def", deadline=1e9, epoch=3, codec="qsparse8_v1",
)


def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("src,dst", [(port, ref), (ref, port)], ids=["port_to_ref", "ref_to_port"])
def test_frames_cross_field_for_field(src, dst):
    assert [f.name for f in dataclasses.fields(src.ActivationFrame)] == \
        [f.name for f in dataclasses.fields(dst.ActivationFrame)]
    frame = src.ActivationFrame(**FULL_FRAME)
    got = dst.ActivationFrame.from_bytes(frame.to_bytes())
    # msgpack turns tuples inside the decoding dict into lists, in either
    # package: the other package reads what the sender itself would
    assert _fields(got) == _fields(src.ActivationFrame.from_bytes(frame.to_bytes()))
    assert got.decoding["stop_token_ids"] == [2, 7] and got.shape == (1, 3, 2048)
    # a frame with only the required fields takes the defaults on both sides
    bare = src.ActivationFrame(nonce="n", seq=0, layer_id=-1, pos=0, dtype="tokens", shape=(1, 2),
                               payload=b"\x01\x00\x00\x00\x02\x00\x00\x00")
    assert _fields(dst.ActivationFrame.from_bytes(bare.to_bytes())) == _fields(bare)


@pytest.mark.parametrize("src,dst", [(port, ref), (ref, port)], ids=["port_to_ref", "ref_to_port"])
def test_control_messages_cross_field_for_field(src, dst):
    msgs = [
        src.StreamAck(nonce="n", seq=3, ok=False, backpressure=True, message="backpressure"),
        src.TokenPayload(nonce="n", step=4, token_id=99, logprob=-0.25, top_ids=[99, 3],
                         top_logprobs=[-0.25, -2.0], error="", epoch=2),
        src.TokenPayload(nonce="n", step=5, token_id=-1, error="boom"),
        src.HealthInfo(ok=True, model="/m", layers=[0, 1], queue_depth=2, epoch=1),
        src.ResetCacheRequest(nonce="n", epoch=4),
        src.Empty(),
    ]
    for m in msgs:
        got = getattr(dst, type(m).__name__).from_bytes(m.to_bytes())
        assert _fields(got) == _fields(m)


def test_messages_become_the_same_engine_objects():
    """A frame unpacked by the port becomes the message its compute reads,
    with the reference's decoding params and ring fields."""
    packed = ref.ActivationFrame(**FULL_FRAME).to_bytes()
    msg = port.ActivationFrame.from_bytes(packed).to_message()
    want = ref.ActivationFrame.from_bytes(packed).to_message()
    for name in ("nonce", "seq", "layer_id", "pos", "dtype", "shape", "callback_url", "auto_steps",
                 "drafts", "committed", "lanes", "prefix_store", "prefix_hit", "deadline", "epoch"):
        assert getattr(msg, name) == getattr(want, name), name
    assert msg.data == want.data
    assert dataclasses.asdict(msg.decoding) == dataclasses.asdict(want.decoding)
    assert dataclasses.asdict(msg.decoding).keys() == dataclasses.asdict(RefDecoding()).keys()
    tr = port.TokenPayload(nonce="n", step=2, token_id=5, top_ids=[5], top_logprobs=[-0.1]).to_result()
    assert (tr.nonce, tr.step, tr.token_id, tr.top_logprobs) == ("n", 2, 5, [(5, -0.1)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("wire_dtype", [None, "float32", "bfloat16"])
def test_tensor_bytes_are_identical(dtype, wire_dtype):
    rng = np.random.default_rng(0)
    if dtype == "int32":
        x = rng.integers(-1000, 1000, size=(2, 3, 5)).astype(np.int32)
    else:
        x = (rng.normal(size=(2, 3, 5)) * 10).astype(np.float32)
        x = x.astype({"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[dtype])
    t = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype)) if dtype != "int32" else torch.from_numpy(x)
    got = ser.tensor_to_bytes(t, wire_dtype=wire_dtype)
    want = ref_ser.tensor_to_bytes(jnp.asarray(x), wire_dtype=wire_dtype)
    assert got == (want[0], want[1], tuple(want[2]))
    # and back: the bytes read into the same values in each package
    back = ser.bytes_to_tensor(*want)
    assert np.array_equal(back.float().numpy(), np.asarray(ref_ser.bytes_to_tensor(*want)).astype(np.float32))
    assert ser.dtype_name(back.dtype) == want[1]


def test_numpy_input_and_size_checks():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert ser.tensor_to_bytes(x) == ref_ser.tensor_to_bytes(x)
    assert ser.numpy_dtype("bf16") == np.uint16 and ser.canonical_dtype_name("F32") == "float32"
    with pytest.raises(ValueError, match="payload size mismatch"):
        ser.bytes_to_tensor(b"\x00" * 7, "float32", (2,))
    with pytest.raises(ValueError):
        ser.torch_dtype("complex64")
