"""The port's quantized KV cache (core/kvcache.py) against dnet_tpu's.

Codes and scales must equal the reference's bit for bit on the same f32 and
bf16 inputs (a swapped nibble or a multiplied reciprocal would still give
plausible text).  Round trips keep the reference's own tolerances
(tests/test_kv_quant.py:23-63); cache structure, byte counts and the
kv_bits mapping match the reference's.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dnet_tpu.core import kvcache as ref
from dnet_tpu_torch.core import kvcache as port

pytestmark = pytest.mark.core


def _inputs(rng, dtype):
    # a wide spread of magnitudes, exact ties at .5 after scaling, and
    # all-zero rows (scale floor 1e-8)
    x = rng.normal(0.0, 2.0, size=(2, 5, 3, 16)).astype(np.float32)
    x[0, 0] *= 1e-3
    x[1, 1, 0] = 0.0
    x[1, 2, 1] = np.arange(16, dtype=np.float32) - 7.0  # amax 8: codes on .5 ties for q4
    if dtype == "bfloat16":
        xb = x.astype(ml_dtypes.bfloat16)
        return jnp.asarray(xb), torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_codes_and_scales_bit_equal(rng, dtype, bits):
    xj, xt = _inputs(rng, dtype)
    ref_q = ref._quantize_q8 if bits == 8 else ref._quantize_q4
    port_q = port._quantize_q8 if bits == 8 else port._quantize_q4
    rq, rs = ref_q(xj)
    pq, ps = port_q(xt)
    assert pq.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    if bits == 4:
        np.testing.assert_array_equal(port._unpack_q4(pq).numpy(), np.asarray(ref._unpack_q4(rq)))


def test_unpack_q4_every_byte():
    """Every byte value: low nibble at the even index, high at the odd."""
    p = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = port._unpack_q4(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref._unpack_q4(jnp.asarray(p))))
    assert got[0, 2] == (1 & 0xF) - 8 and got[0, 3] == (1 >> 4) - 8


def _cfgs(bits, **kw):
    base = dict(n_layers=2, batch=3, max_seq=128, n_kv_heads=4, head_dim=64, quant_bits=bits, **kw)
    return ref.KVConfig(**base), port.KVConfig(**base)


@pytest.mark.parametrize("bits,dtype", [(0, "bfloat16"), (0, "float32"), (8, "bfloat16"), (4, "bfloat16")])
def test_init_cache_and_nbytes_match_the_reference(bits, dtype):
    rc, pc = _cfgs(bits, dtype=dtype)
    want = ref.init_cache(rc)
    got = port.init_cache(pc, torch.device("cpu"))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape
        assert str(got[name].dtype).split(".")[-1] == str(arr.dtype)
        assert not got[name].any()
    assert port.cache_nbytes(pc) == ref.cache_nbytes(rc)
    assert port.cache_nbytes(pc) == sum(t.numel() * t.element_size() for t in got.values())


def test_full_width_cache_bytes():
    """Llama-3.2-1B, max_seq 4096, one sequence: the sizes users buy with
    DNET_KV_BITS."""
    sizes = {
        bits: port.cache_nbytes(port.KVConfig(16, 1, 4096, 8, 64, quant_bits=bits))
        for bits in (0, 8, 4)
    }
    assert sizes == {0: 134_217_728, 8: 71_303_168, 4: 37_748_736}


@pytest.mark.parametrize("kv_bits", [0, 4, 8, 16])
def test_resolve_kv_bits_matches_the_reference(kv_bits):
    assert port.resolve_kv_bits(kv_bits) == ref.resolve_kv_bits(kv_bits)


@pytest.mark.parametrize("kv_bits", [2, 3, 32])
def test_resolve_kv_bits_refuses_what_the_reference_refuses(kv_bits):
    with pytest.raises(NotImplementedError):
        ref.resolve_kv_bits(kv_bits)
    with pytest.raises(NotImplementedError):
        port.resolve_kv_bits(kv_bits)


def test_unsupported_bits_and_odd_q4_head_dim_raise():
    with pytest.raises(NotImplementedError):
        port.init_cache(port.KVConfig(1, 1, 8, 1, 8, quant_bits=2), torch.device("cpu"))
    with pytest.raises(ValueError, match="even"):
        port.init_cache(port.KVConfig(1, 1, 8, 1, 7, quant_bits=4), torch.device("cpu"))


@pytest.mark.parametrize("bits,k_tol,v_tol", [(8, dict(atol=0.04, rtol=0.03), dict(atol=0.01, rtol=0.03)),
                                              (4, dict(atol=0.45), dict(atol=0.12))])
def test_write_read_round_trip(bits, k_tol, v_tol):
    """tests/test_kv_quant.py's round trips, and the same cache entries as
    the reference's write_kv."""
    rc = ref.KVConfig(1, 1, 16, 2, 8, quant_bits=bits)
    pc = port.KVConfig(1, 1, 16, 2, 8, quant_bits=bits)
    rng = np.random.default_rng(0)
    k_new = rng.normal(0, 2.0, (1, 3, 2, 8)).astype(np.float32)
    v_new = rng.normal(0, 0.5, (1, 3, 2, 8)).astype(np.float32)
    want = ref.write_kv({n: a[0] for n, a in ref.init_cache(rc).items()}, jnp.asarray(k_new),
                        jnp.asarray(v_new), jnp.int32(4))
    kvs = port.layer_slices(port.init_cache(pc, torch.device("cpu")), 0)
    got = port.write_kv(kvs, torch.from_numpy(k_new), torch.from_numpy(v_new), 4)
    assert got is kvs
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    k, v = port.read_kv(kvs)
    np.testing.assert_allclose(k[0, 4:7].numpy(), k_new[0], **k_tol)
    np.testing.assert_allclose(v[0, 4:7].numpy(), v_new[0], **v_tol)
    assert not k[0, :4].any() and not k[0, 7:].any()  # unwritten slots read 0
    rk, rv = ref.read_kv(want)
    np.testing.assert_array_equal(k.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    k5, v5 = port.read_kv(kvs, upto=5)
    assert k5.shape == (1, 5, 2, 8) and torch.equal(k5, k[:, :5]) and torch.equal(v5, v[:, :5])


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_write_kv_rows_touches_only_the_listed_lanes(rng, bits):
    """The batched decode's write: lanes 0 and 2 get one row each at their
    own positions, codes and scales together; lane 1 keeps its contents."""
    cfg = port.KVConfig(1, 3, 16, 2, 8, dtype="float32", quant_bits=bits)
    kvs = port.layer_slices(port.init_cache(cfg, torch.device("cpu")), 0)
    port.write_kv(kvs, *(torch.from_numpy(rng.normal(size=(3, 16, 2, 8)).astype(np.float32)) for _ in "kv"), 0)
    before = {n: t.clone() for n, t in kvs.items()}
    rows = [torch.from_numpy(rng.normal(size=(2, 2, 8)).astype(np.float32)) for _ in "kv"]
    lanes, positions = torch.tensor([0, 2]), torch.tensor([5, 11])
    port.write_kv_rows(kvs, *rows, lanes, positions)
    enc = port._encoded(kvs, *rows)
    for name, t in kvs.items():
        assert torch.equal(t[1], before[name][1])
        for i, (lane, p) in enumerate(zip(lanes.tolist(), positions.tolist())):
            assert torch.equal(t[lane, p], enc[name][i])
            rest = torch.ones(16, dtype=torch.bool)
            rest[p] = False
            assert torch.equal(t[lane, rest], before[name][lane, rest])


def test_write_kv_raises_outside_the_cache():
    kvs = port.layer_slices(port.init_cache(port.KVConfig(1, 1, 8, 1, 8, quant_bits=8), torch.device("cpu")), 0)
    x = torch.zeros(1, 2, 1, 8)
    with pytest.raises(ValueError, match="outside"):
        port.write_kv(kvs, x, x, 7)
