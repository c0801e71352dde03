"""The ring-buffer KV write (gpt_oss's sliding layers) against dnet_tpu's
write_kv_rotating, bit for bit.

Both packages start from the same ring contents (random codes, scales or
bf16 values, so a slot that must stay untouched shows if it moves) and
write the same f32 chunk: of 1 token, fewer than W, exactly W, more than W
and 3W tokens, at starts that land the chunk across the wrap, with bucket
padding (t_real < T) that must never reach the ring.  The bf16 ring holds
the rounded values, the q8 / q4 rings codes and f32 scales: every byte
must equal the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu.core.kvcache import write_kv_rotating as ref_write
from dnet_tpu_torch.core.kvcache import write_kv_rotating

pytestmark = pytest.mark.core

W, KVH, HD = 16, 2, 8


def _ring(rng, form):
    """Random ring contents [B=1, W, KVH, *] as numpy arrays."""
    shape = (1, W, KVH, HD)
    if form == "bf16":
        return {n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
    codes = {8: lambda: rng.integers(-127, 128, size=shape, dtype=np.int8),
             4: lambda: rng.integers(0, 256, size=(1, W, KVH, HD // 2), dtype=np.uint8)}[form]
    ring = {n: codes() for n in ("k", "v")}
    ring.update({f"{n}_scale": rng.uniform(0.01, 0.1, size=(1, W, KVH, 1)).astype(np.float32) for n in ("k", "v")})
    return ring


def _as_ref(ring, form):
    return {n: jnp.asarray(a, jnp.bfloat16) if form == "bf16" else jnp.asarray(a) for n, a in ring.items()}


def _as_port(ring, form):
    return {n: torch.from_numpy(a.copy()).to(torch.bfloat16) if form == "bf16" else torch.from_numpy(a.copy())
            for n, a in ring.items()}


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("form", ["bf16", 8, 4])
@pytest.mark.parametrize("T,t_real", [(1, None), (5, None), (16, None), (23, None), (48, None),
                                      (16, 11), (32, 19), (64, 40), (8, 0)])
@pytest.mark.parametrize("pos", [0, 3, 13, 16, 37])
def test_matches_reference_bit_for_bit(rng, form, T, t_real, pos):
    ring = _ring(rng, form)
    k_new = rng.normal(size=(1, T, KVH, HD)).astype(np.float32)
    v_new = rng.normal(size=(1, T, KVH, HD)).astype(np.float32)
    want = ref_write(_as_ref(ring, form), jnp.asarray(k_new), jnp.asarray(v_new), jnp.int32(pos),
                     t_real=None if t_real is None else jnp.int32(t_real))
    got = _as_port(ring, form)
    out = write_kv_rotating(got, torch.from_numpy(k_new), torch.from_numpy(v_new), pos, t_real=t_real)
    assert out is got  # written in place
    for name in ring:
        np.testing.assert_array_equal(_host(got[name]), _host(want[name]), err_msg=name)


def test_padding_never_reaches_the_ring(rng):
    """NaN bucket padding past t_real leaves every slot finite, and the slots
    the real tokens do not reach keep their old contents."""
    ring = _as_port(_ring(rng, "bf16"), "bf16")
    before = {n: t.clone() for n, t in ring.items()}
    k_new = torch.randn(1, 16, KVH, HD)
    k_new[:, 5:] = float("nan")
    write_kv_rotating(ring, k_new, k_new.clone(), 14, t_real=5)  # slots 14, 15, 0, 1, 2
    for n in ring:
        assert torch.isfinite(ring[n].float()).all()
        torch.testing.assert_close(ring[n][:, 3:14], before[n][:, 3:14], rtol=0, atol=0)
