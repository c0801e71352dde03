"""The decode kernel's rotating variant (gpt_oss's sliding-window ring
buffer): its plain version against dnet_tpu's Pallas kernel with
rotating=True.

On the CPU the port's wrapper runs its plain version; the reference runs
its real split-K Pallas kernel in interpret mode.  The ring holds W = 128
slots (gpt-oss-20b's window; the port's 64-key tiles split it in two, the
reference's tile is the whole ring), the query sits before, at and after
each wrap, and the window is the ring (the served case) or shorter.
Quantized rings are filled by both packages' write_kv_rotating, one token
at a time across two wraps.  Tolerance: f32 2e-5
(tests/test_flash_decode.py:41).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu_torch.core.kvcache import KVConfig, init_cache, layer_slices, write_kv_rotating
from dnet_tpu_torch.ops.attention import attend
from dnet_tpu_torch.ops.flash_decode import flash_decode_attend

pytestmark = pytest.mark.core

TOL = dict(atol=2e-5, rtol=2e-5)
W = 128
POSITIONS = [0, W - 2, W - 1, W, W + 1, 2 * W + 5, 4095]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DNET_FLASH_INTERPRET", "1")


def _mk(rng, B, H, KVH, Hd=16):
    return (
        rng.normal(size=(B, 1, H, Hd)).astype(np.float32),
        rng.normal(size=(B, W, KVH, Hd)).astype(np.float32),
        rng.normal(size=(B, W, KVH, Hd)).astype(np.float32),
    )


def _port(q, k, v, positions, window, sinks=None, k_scale=None, v_scale=None):
    """The port's wrapper, lane b at positions[b]."""
    lengths = torch.tensor([p + 1 for p in positions], dtype=torch.int32)
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))  # noqa: E731
    out = flash_decode_attend(
        t(q), t(k), t(v), lengths, min(max(positions) + 1, W), sinks=t(sinks),
        k_scale=t(k_scale), v_scale=t(v_scale), rotating=True, window=window,
    )
    return out.numpy()


def _ref(q, k, v, pos, window, sinks=None, k_scale=None, v_scale=None):
    from dnet_tpu.ops.flash_decode import flash_decode_attend as ref_decode
    from dnet_tpu.ops.flash_decode import flash_decode_eligible

    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    assert flash_decode_eligible(j(q), j(k))
    return np.asarray(ref_decode(
        j(q), j(k), j(v), jnp.int32(pos), sinks=j(sinks), window=window, rotating=True,
        k_scale=j(k_scale), v_scale=j(v_scale),
    ))


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("window", [W, W - 37])
@pytest.mark.parametrize("with_sinks", [False, True])
@pytest.mark.parametrize("H,KVH", [(4, 2), (8, 1)])
def test_matches_reference_kernel(rng, pos, window, with_sinks, H, KVH):
    q, k, v = _mk(rng, 1, H, KVH)
    sinks = rng.normal(size=(H,)).astype(np.float32) if with_sinks else None
    np.testing.assert_allclose(_port(q, k, v, [pos], window, sinks), _ref(q, k, v, pos, window, sinks), **TOL)


@pytest.mark.parametrize("positions", [(W + 1, 40), (3, 2 * W + 5), (0, 4095)])
def test_lanes_at_different_positions(rng, positions):
    """One launch over two lanes, each at its own position: each lane as the
    reference gives it alone."""
    q, k, v = _mk(rng, 2, 8, 2)
    sinks = rng.normal(size=(8,)).astype(np.float32)
    got = _port(q, k, v, list(positions), W - 5, sinks)
    for b, pos in enumerate(positions):
        want = _ref(q[b : b + 1], k[b : b + 1], v[b : b + 1], pos, W - 5, sinks)
        np.testing.assert_allclose(got[b : b + 1], want, **TOL)


def test_matches_the_dense_window(rng):
    """The ring's mask spelled out: slot s holds pos - ((pos - s) mod W),
    attended inside the window; the dense attend over it agrees."""
    q, k, v = _mk(rng, 1, 4, 2)
    pos, window = 300, 100
    a = pos - np.mod(pos - np.arange(W), W)
    mask = torch.from_numpy(((a >= 0) & (a > pos - window))[None, :])
    want = attend(*(torch.from_numpy(x) for x in (q, k, v)), mask=mask)
    np.testing.assert_allclose(_port(q, k, v, [pos], window), want.numpy(), **TOL)


def test_window_outside_the_ring_is_refused(rng):
    q, k, v = (torch.from_numpy(a) for a in _mk(rng, 1, 4, 2))
    lengths = torch.tensor([5], dtype=torch.int32)
    for window in (0, W + 1):
        with pytest.raises(ValueError, match="window"):
            flash_decode_attend(q, k, v, lengths, 5, rotating=True, window=window)


def _filled_rings(rng, bits, n_tokens, KVH=2, Hd=16):
    """Quantized rings of W slots filled one token at a time by both
    packages' write_kv_rotating from the same f32 rows."""
    from dnet_tpu.core.kvcache import KVConfig as RefKVConfig
    from dnet_tpu.core.kvcache import init_cache as ref_init_cache
    from dnet_tpu.core.kvcache import write_kv_rotating as ref_write

    ref = {n: a[0] for n, a in ref_init_cache(RefKVConfig(1, 1, W, KVH, Hd, quant_bits=bits)).items()}
    port = layer_slices(init_cache(KVConfig(1, 1, W, KVH, Hd, quant_bits=bits), torch.device("cpu")), 0)
    for t in range(n_tokens):
        k_new = rng.normal(size=(1, 1, KVH, Hd)).astype(np.float32)
        v_new = rng.normal(size=(1, 1, KVH, Hd)).astype(np.float32)
        ref = ref_write(ref, jnp.asarray(k_new), jnp.asarray(v_new), jnp.int32(t))
        write_kv_rotating(port, torch.from_numpy(k_new), torch.from_numpy(v_new), t)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(ref[name]))
    return ref, port


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n_tokens,window", [(W - 1, W), (2 * W + 6, W), (2 * W + 6, W - 37)])
def test_quantized_ring_matches_reference_kernel(rng, bits, n_tokens, window):
    ref, port = _filled_rings(rng, bits, n_tokens)
    pos = n_tokens - 1
    q = rng.normal(size=(1, 1, 4, 16)).astype(np.float32)
    sinks = rng.normal(size=(4,)).astype(np.float32)
    want = _ref(q, ref["k"], ref["v"], pos, window, sinks, ref["k_scale"], ref["v_scale"])
    got = _port(q, port["k"].numpy(), port["v"].numpy(), [pos], window, sinks,
                port["k_scale"].numpy(), port["v_scale"].numpy())
    np.testing.assert_allclose(got, want, **TOL)
