"""The port's tensor ops against dnet_tpu's on the same numpy inputs.

Tolerance: f32 2e-5, the repo's kernel tolerance (tests/test_flash_decode.py:41):
both sides compute in f32 and differ only in summation order and in the
libm of cos/sin/exp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu.ops import attention as ref_attention
from dnet_tpu.ops import norms as ref_norms
from dnet_tpu.ops import rope as ref_rope
from dnet_tpu_torch.core.kvcache import KVConfig, init_cache, write_kv
from dnet_tpu_torch.ops import attention, norms, rope

pytestmark = pytest.mark.core

TOL = dict(atol=2e-5, rtol=2e-5)

LLAMA3_SCALING = {
    "rope_type": "llama3",
    "factor": 32.0,
    "low_freq_factor": 1.0,
    "high_freq_factor": 4.0,
    "original_max_position_embeddings": 8192,
}


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 5, 64), (1, 3, 7, 48)])
def test_rms_norm(rng, shape):
    x, w = _np(rng, *shape), _np(rng, shape[-1])
    want = np.asarray(ref_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "head_dim,theta,scaling",
    [
        (64, 500000.0, LLAMA3_SCALING),
        (16, 10000.0, None),
        (32, 10000.0, {"rope_type": "linear", "factor": 4.0}),
    ],
)
def test_rope(rng, head_dim, theta, scaling):
    inv_ref, sc_ref = ref_rope.rope_frequencies(head_dim, theta, scaling, 131072)
    inv, sc = rope.rope_frequencies(head_dim, theta, scaling, 131072)
    np.testing.assert_array_equal(inv, inv_ref)
    assert sc == sc_ref
    x = _np(rng, 2, 7, 3, head_dim)
    pos = 1000 + np.arange(7, dtype=np.int32)
    want = np.asarray(ref_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv_ref), sc_ref))
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(inv), sc).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_causal_mask():
    want = np.asarray(ref_attention.causal_mask(5, 12, 4))
    np.testing.assert_array_equal(attention.causal_mask(5, 12, 4).numpy(), want)


@pytest.mark.parametrize("B,T,H,KVH,Hd,S,pos,sinks", [
    (1, 6, 4, 2, 16, 20, 3, False),
    (2, 1, 8, 2, 16, 33, 32, True),
    (1, 9, 4, 4, 32, 9, 0, True),
])
def test_attend(rng, B, T, H, KVH, Hd, S, pos, sinks):
    q, k, v = _np(rng, B, T, H, Hd), _np(rng, B, S, KVH, Hd), _np(rng, B, S, KVH, Hd)
    sk = _np(rng, H) if sinks else None
    want = ref_attention.attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=ref_attention.causal_mask(T, S, pos),
        sinks=None if sk is None else jnp.asarray(sk),
    )
    got = attention.attend(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=attention.causal_mask(T, S, pos),
        sinks=None if sk is None else torch.from_numpy(sk),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cached_attend_writes_then_attends(rng):
    """cached_attend(causal=True) = write the chunk at pos, then causal
    attention over the whole cache (the dense reference on the same cache)."""
    B, T, H, KVH, Hd, S, pos = 1, 5, 4, 2, 16, 24, 7
    kvs = {n: torch.from_numpy(_np(rng, B, S, KVH, Hd)) for n in ("k", "v")}
    q, kn, vn = (torch.from_numpy(_np(rng, B, T, n, Hd)) for n in (H, KVH, KVH))
    out, kvs = attention.cached_attend(q, kn, vn, kvs, pos, None, causal=True)
    torch.testing.assert_close(kvs["k"][:, pos:pos + T], kn)
    want = ref_attention.attend(
        jnp.asarray(q.numpy()), jnp.asarray(kvs["k"].numpy()), jnp.asarray(kvs["v"].numpy()),
        mask=ref_attention.causal_mask(T, S, pos),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_write_kv_refuses_out_of_range():
    """JAX clamps an out-of-range dynamic_update_slice start; the port raises
    instead of shifting the write."""
    kv = init_cache(KVConfig(1, 1, 8, 2, 4, dtype="float32"), torch.device("cpu"))
    kvs = {n: a[0] for n, a in kv.items()}
    new = torch.ones(1, 3, 2, 4)
    write_kv(kvs, new, new, 5)
    assert kv["k"][0, 0, 5:].eq(1).all()
    with pytest.raises(ValueError):
        write_kv(kvs, new, new, 6)
