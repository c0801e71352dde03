"""The quantized decode kernel's plain version, and the lengths vector,
against dnet_tpu's Pallas decode kernel.

On the CPU the port's wrapper runs its plain version; the reference runs
its split-K Pallas kernel (`qbits` 8/4 variant) in interpret mode.  Each
package writes its own cache with its own `write_kv` from the same numpy
rows: the prompt as one chunk, then the last tokens one at a time, as
prefill and decode write it.  Positions sit on and around tile edges of
both (the port's 64-key tiles, the reference's 256-key tiles at S=512).
The lengths vector is held against one reference call per lane.
Tolerance: f32 2e-5 (tests/test_flash_decode.py:191-220).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu.core import kvcache as ref_kv
from dnet_tpu_torch.core import kvcache as port_kv
from dnet_tpu_torch.ops.flash_decode import decode_lengths, flash_decode_attend

pytestmark = pytest.mark.core

TOL = dict(atol=2e-5, rtol=2e-5)
S, D = 512, 16


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DNET_FLASH_INTERPRET", "1")


def _caches(rng, bits, B, KVH, n_tokens, decode_tokens=3):
    """Both packages' caches holding the same n_tokens rows per lane."""
    rk = rng.normal(size=(B, n_tokens, KVH, D)).astype(np.float32)
    rv = rng.normal(0.0, 0.5, size=(B, n_tokens, KVH, D)).astype(np.float32)
    ref_cfg = ref_kv.KVConfig(1, B, S, KVH, D, dtype="float32", quant_bits=bits)
    port_cfg = port_kv.KVConfig(1, B, S, KVH, D, dtype="float32", quant_bits=bits)
    ref = {n: a[0] for n, a in ref_kv.init_cache(ref_cfg).items()}
    port = port_kv.layer_slices(port_kv.init_cache(port_cfg, torch.device("cpu")), 0)
    cut = max(n_tokens - decode_tokens, 0)
    spans = ([(0, cut)] if cut else []) + [(t, t + 1) for t in range(cut, n_tokens)]
    for a, b in spans:
        ref = ref_kv.write_kv(ref, jnp.asarray(rk[:, a:b]), jnp.asarray(rv[:, a:b]), jnp.int32(a))
        port_kv.write_kv(port, torch.from_numpy(rk[:, a:b]), torch.from_numpy(rv[:, a:b]), a)
    for name in ref:
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(ref[name]))
    return ref, port


def _ref_decode(q, ref, pos, sinks=None):
    from dnet_tpu.ops.flash_decode import flash_decode_attend as ref_decode
    from dnet_tpu.ops.flash_decode import flash_decode_eligible

    assert flash_decode_eligible(jnp.asarray(q), ref["k"])
    return np.asarray(ref_decode(
        jnp.asarray(q), ref["k"], ref["v"], jnp.int32(pos),
        sinks=None if sinks is None else jnp.asarray(sinks),
        k_scale=ref["k_scale"], v_scale=ref["v_scale"],
    ))


def _port_decode(q, port, lengths, **kw):
    lengths = torch.tensor(lengths, dtype=torch.int32)
    return flash_decode_attend(
        torch.from_numpy(q), port["k"], port["v"], lengths, int(lengths.max()),
        k_scale=port["k_scale"], v_scale=port["v_scale"], **kw,
    ).numpy()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("pos", [0, 63, 64, 255, 256, S - 1])
@pytest.mark.parametrize("H,KVH", [(2, 2), (8, 2)])  # G = 1 and 4
def test_quantized_decode_matches_reference_kernel(rng, bits, pos, H, KVH):
    ref, port = _caches(rng, bits, 2, KVH, pos + 1)
    q = rng.normal(size=(2, 1, H, D)).astype(np.float32)
    np.testing.assert_allclose(_port_decode(q, port, [pos + 1] * 2), _ref_decode(q, ref, pos), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_decode_with_sinks(rng, bits):
    ref, port = _caches(rng, bits, 1, 2, 300)
    q = rng.normal(size=(1, 1, 8, D)).astype(np.float32)
    sinks = rng.normal(size=(8,)).astype(np.float32)
    got = _port_decode(q, port, [300], sinks=torch.from_numpy(sinks))
    np.testing.assert_allclose(got, _ref_decode(q, ref, 299, sinks), **TOL)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_lengths_vector_matches_per_lane_calls(rng, bits):
    """Lanes at ragged positions (tile edges, mid-tile, an idle lane) in one
    call: each lane equals the reference kernel run on that lane alone at
    its position; the idle lane (length 0) gives zeros."""
    lengths = [65, 0, 300, 1, 256]
    B, H, KVH = len(lengths), 8, 2
    n = max(lengths)
    rk = rng.normal(size=(B, n, KVH, D)).astype(np.float32)
    rv = rng.normal(size=(B, n, KVH, D)).astype(np.float32)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    cfg = dict(n_layers=1, batch=B, max_seq=S, n_kv_heads=KVH, head_dim=D, dtype="float32", quant_bits=bits)
    ref = {k: a[0] for k, a in ref_kv.init_cache(ref_kv.KVConfig(**cfg)).items()}
    ref = ref_kv.write_kv(ref, jnp.asarray(rk), jnp.asarray(rv), jnp.int32(0))
    port = port_kv.layer_slices(port_kv.init_cache(port_kv.KVConfig(**cfg), torch.device("cpu")), 0)
    port_kv.write_kv(port, torch.from_numpy(rk), torch.from_numpy(rv), 0)
    scales = {"k_scale": port["k_scale"], "v_scale": port["v_scale"]} if bits else {}
    got = flash_decode_attend(
        torch.from_numpy(q), port["k"], port["v"], torch.tensor(lengths, dtype=torch.int32), n, **scales,
    ).numpy()
    from dnet_tpu.ops.flash_decode import flash_decode_attend as ref_decode

    for b, length in enumerate(lengths):
        if length == 0:
            assert not got[b].any()
            continue
        lane = {k: a[b : b + 1] for k, a in ref.items()}
        want = ref_decode(jnp.asarray(q[b : b + 1]), lane["k"], lane["v"], jnp.int32(length - 1),
                          k_scale=lane.get("k_scale"), v_scale=lane.get("v_scale"))
        np.testing.assert_allclose(got[b : b + 1], np.asarray(want), **TOL)


def test_decode_lengths_fills_every_lane():
    got = decode_lengths(3, 41, "cpu")
    assert got.dtype == torch.int32 and got.tolist() == [42, 42, 42]


def test_quantized_decode_reads_no_dead_slot(rng):
    """Slots past a lane's length are never used: stale codes and scales
    there change nothing."""
    _, port = _caches(rng, 8, 1, 2, 100)
    q = rng.normal(size=(1, 1, 4, D)).astype(np.float32)
    want = _port_decode(q, port, [70])
    port["k"][:, 70:] = 127
    port["v_scale"][:, 70:] = float("nan")
    np.testing.assert_array_equal(_port_decode(q, port, [70]), want)


def test_wrapper_refuses_bad_shapes():
    q = torch.zeros(1, 1, 4, D)
    codes = torch.zeros(1, 8, 2, D, dtype=torch.int8)
    scale = torch.zeros(1, 8, 2, 1)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="scales"):
        flash_decode_attend(q, codes, codes, one, 1, k_scale=scale, v_scale=None)
    with pytest.raises(ValueError, match="int8 or uint8"):
        flash_decode_attend(q, codes.float(), codes.float(), one, 1, k_scale=scale, v_scale=scale)
    with pytest.raises(ValueError, match="cache shapes"):  # q4 codes are D/2 wide
        flash_decode_attend(q, codes.to(torch.uint8), codes.to(torch.uint8), one, 1, k_scale=scale,
                            v_scale=scale)
    with pytest.raises(ValueError, match="max_live"):
        flash_decode_attend(q, codes, codes, one, 9, k_scale=scale, v_scale=scale)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("pos", [0, 63, 64, 256, S - 1])
@pytest.mark.parametrize("Hd,Vd", [(24, 12), (192, 128)])
def test_mla_widths_quantized_match_reference_kernel(rng, bits, pos, Hd, Vd):
    """The asymmetric MLA cache (K at Hd, V at Vd, KVH = H: G = 1), int8 and
    packed int4 (K packs Hd/2 bytes a row, V Vd/2), written by each
    package's own write_kv from the same rows: codes bit-equal, the decode
    within 2e-5 of the reference kernel, at the model's softmax scale."""
    B, H = 1, 2
    n = pos + 1
    rk = rng.normal(size=(B, n, H, Hd)).astype(np.float32)
    rv = rng.normal(0.0, 0.5, size=(B, n, H, Vd)).astype(np.float32)
    cfg = dict(n_layers=1, batch=B, max_seq=S, n_kv_heads=H, head_dim=Hd, dtype="float32", v_head_dim=Vd,
               quant_bits=bits)
    ref = {k: a[0] for k, a in ref_kv.init_cache(ref_kv.KVConfig(**cfg)).items()}
    ref = ref_kv.write_kv(ref, jnp.asarray(rk), jnp.asarray(rv), jnp.int32(0))
    port = port_kv.layer_slices(port_kv.init_cache(port_kv.KVConfig(**cfg), torch.device("cpu")), 0)
    port_kv.write_kv(port, torch.from_numpy(rk), torch.from_numpy(rv), 0)
    for name in ref:
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(ref[name]))
    q = rng.normal(size=(B, 1, H, Hd)).astype(np.float32)
    scale = 0.9 * Hd**-0.5
    from dnet_tpu.ops.flash_decode import flash_decode_attend as ref_decode

    want = ref_decode(jnp.asarray(q), ref["k"], ref["v"], jnp.int32(pos), scale=scale,
                      k_scale=ref["k_scale"], v_scale=ref["v_scale"])
    got = _port_decode(q, port, [n], scale=scale)
    assert got.shape == (B, 1, H, Vd)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
