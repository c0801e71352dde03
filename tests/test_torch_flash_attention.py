"""The prefill kernel's plain version against dnet_tpu's Pallas kernel.

On the CPU the port's wrapper runs its plain version (the CUDA kernel needs
the card); the reference runs its real Pallas kernel in interpret mode, as
tests/test_flash_attention.py runs it.  Tolerance: f32 2e-5, the repo's
kernel tolerance (tests/test_flash_decode.py:41).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu.ops.attention import attend, causal_mask
from dnet_tpu_torch.ops.flash_attention import flash_attend_causal, flash_prefill

pytestmark = pytest.mark.core

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _force_kernel(monkeypatch):
    # the reference's REAL kernel via the pallas interpreter on CPU
    monkeypatch.setenv("DNET_FLASH_INTERPRET", "1")


def _mk(rng, B, T, H, KVH, Hd, S):
    return (
        rng.normal(size=(B, T, H, Hd)).astype(np.float32),
        rng.normal(size=(B, S, KVH, Hd)).astype(np.float32),
        rng.normal(size=(B, S, KVH, Hd)).astype(np.float32),
    )


@pytest.mark.parametrize(
    "B,T,H,KVH,Hd,S,pos",
    [
        (1, 16, 4, 4, 16, 32, 0),  # MHA, fresh cache
        (2, 32, 4, 2, 16, 64, 8),  # GQA, continued session
        (1, 8, 8, 2, 32, 8, 0),  # T == S, 4x grouping
        (1, 64, 2, 1, 16, 256, 96),  # long cache, late chunk (MQA)
    ],
)
def test_matches_reference_kernel(rng, B, T, H, KVH, Hd, S, pos):
    from dnet_tpu.ops.flash_attention import flash_attend_causal as ref_flash
    from dnet_tpu.ops.flash_attention import flash_eligible

    q, k, v = _mk(rng, B, T, H, KVH, Hd, S)
    assert flash_eligible(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos)
    got = flash_attend_causal(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sinks_match_reference_kernel(rng):
    from dnet_tpu.ops.flash_attention import flash_attend_causal as ref_flash

    q, k, v = _mk(rng, 1, 16, 4, 2, 16, 64)
    sinks = rng.normal(size=(4,)).astype(np.float32)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 5, sinks=jnp.asarray(sinks))
    got = flash_attend_causal(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 5,
        sinks=torch.from_numpy(sinks),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "B,T,H,KVH,Hd,S,pos",
    [
        (1, 21, 4, 2, 16, 45, 3),  # T and S off every tile size
        (2, 70, 8, 2, 16, 150, 20),  # T spans two 64-row tiles
        (1, 13, 4, 1, 64, 13, 0),  # T == S, non-pow2 (a bucket cut at max_seq)
        (1, 100, 4, 4, 16, 200, 100),  # chunk ends exactly at the cache end
    ],
)
def test_ragged_shapes_match_dense(rng, B, T, H, KVH, Hd, S, pos):
    """Shapes the TPU gate refuses (no tile divides T or S) but the port
    serves: compared with the reference's dense attention."""
    q, k, v = _mk(rng, B, T, H, KVH, Hd, S)
    want = attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=causal_mask(T, S, pos))
    got = flash_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chunk_past_cache_end_raises(rng):
    q, k, v = (torch.from_numpy(a) for a in _mk(rng, 1, 8, 4, 2, 16, 16))
    with pytest.raises(ValueError):
        flash_prefill(q, k, v, 9)


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses anything but CUDA tensors instead of computing elsewhere."""
    q = torch.empty(1, 16, 4, 64, device="meta")
    k = torch.empty(1, 32, 2, 64, device="meta")
    launches = flash_prefill.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill(q, k, k, 0)
    assert flash_prefill.launches == launches



@pytest.mark.parametrize(
    "B,T,H,KVH,Hd,Vd,S,pos",
    [
        (1, 16, 4, 4, 24, 12, 32, 0),  # the tiny deepseek_v2's MLA widths, G = 1
        (2, 32, 4, 4, 24, 12, 64, 8),  # continued session
        (1, 64, 2, 2, 192, 128, 128, 32),  # DeepSeek-V2-Lite's (192, 128)
        (1, 16, 8, 2, 32, 16, 64, 16),  # Dv != Dqk under grouping
    ],
)
def test_mla_widths_match_reference_kernel(rng, B, T, H, KVH, Hd, Vd, S, pos):
    """V's head dim other than Q/K's, with the model's own softmax scale:
    the plain version against the reference's kernel (flash_eligible takes
    Dv != Dqk)."""
    from dnet_tpu.ops.flash_attention import flash_attend_causal as ref_flash
    from dnet_tpu.ops.flash_attention import flash_eligible

    q, k, _ = _mk(rng, B, T, H, KVH, Hd, S)
    v = rng.normal(size=(B, S, KVH, Vd)).astype(np.float32)
    scale = 0.7 * Hd**-0.5
    assert flash_eligible(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, scale=scale)
    got = flash_attend_causal(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos, scale=scale)
    assert got.shape == (B, T, H, Vd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_widths_ragged_shape_matches_dense(rng):
    """A T and S off every tile, at Dv != Dqk: against the reference's
    dense attention."""
    q, k, _ = _mk(rng, 1, 21, 4, 4, 24, 45)
    v = rng.normal(size=(1, 45, 4, 12)).astype(np.float32)
    want = attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=causal_mask(21, 45, 3))
    got = flash_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_v_rows_must_match_k_rows(rng):
    q, k, v = (torch.from_numpy(a) for a in _mk(rng, 1, 8, 4, 4, 24, 16))
    with pytest.raises(ValueError):
        flash_prefill(q, k, v[:, :8, :, :12], 0)
