"""The decode kernel's plain version against dnet_tpu's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the reference runs
its real split-K Pallas kernel in interpret mode.  Positions sit on and
around tile edges of both (the port's 64-key tiles, the reference's
256-key tiles at S=512) and at the cache's last slot.  Tolerance: f32 2e-5
(tests/test_flash_decode.py:41).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu_torch.ops.flash_decode import decode_lengths, flash_decode_attend
from dnet_tpu_torch.ops.paged_attention import paged_plan

pytestmark = pytest.mark.core

TOL = dict(atol=2e-5, rtol=2e-5)
S = 512


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DNET_FLASH_INTERPRET", "1")


def _mk(rng, B, H, KVH, Hd, S):
    return (
        rng.normal(size=(B, 1, H, Hd)).astype(np.float32),
        rng.normal(size=(B, S, KVH, Hd)).astype(np.float32),
        rng.normal(size=(B, S, KVH, Hd)).astype(np.float32),
    )


def _attend(q, k, v, pos, **kw):
    """The port's wrapper with every lane at `pos`."""
    return flash_decode_attend(q, k, v, decode_lengths(q.shape[0], pos, q.device), pos + 1, **kw)


def _ref(q, k, v, pos, sinks=None):
    from dnet_tpu.ops.flash_decode import flash_decode_attend as ref_decode
    from dnet_tpu.ops.flash_decode import flash_decode_eligible

    assert flash_decode_eligible(jnp.asarray(q), jnp.asarray(k))
    return np.asarray(ref_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
        sinks=None if sinks is None else jnp.asarray(sinks),
    ))


@pytest.mark.parametrize("pos", [0, 63, 64, 255, 256, S - 1])
@pytest.mark.parametrize("H,KVH", [(4, 2), (8, 2), (4, 4)])
def test_matches_reference_kernel(rng, pos, H, KVH):
    q, k, v = _mk(rng, 2, H, KVH, 16, S)
    got = _attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos)
    np.testing.assert_allclose(got.numpy(), _ref(q, k, v, pos), **TOL)


def test_sinks_match_reference_kernel(rng):
    q, k, v = _mk(rng, 1, 8, 2, 16, S)
    sinks = rng.normal(size=(8,)).astype(np.float32)
    got = _attend(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 300,
        sinks=torch.from_numpy(sinks),
    )
    np.testing.assert_allclose(got.numpy(), _ref(q, k, v, 300, sinks), **TOL)


def test_dead_slots_are_never_read(rng):
    """Slots past pos are not attended: NaN garbage there changes nothing."""
    q, k, v = (torch.from_numpy(a) for a in _mk(rng, 1, 4, 2, 16, 128))
    want = _attend(q, k, v, 70)
    k[:, 71:] = float("nan")
    v[:, 71:] = float("nan")
    torch.testing.assert_close(_attend(q, k, v, 70), want)


@pytest.mark.parametrize("live,slots,per_sm,want", [
    (1, 1, 1, 1),  # one tile
    (4096, 1, 1, 16),  # 64 tiles: the split cap
    (1025, 1, 1, 9),  # 17 tiles, two or more a split
    (1530, 8, 2, 32),  # batch_serve's 8 lanes x 8 KV heads, two blocks an SM: one wave
])
def test_split_plan_covers_live_tiles(live, slots, per_sm, want):
    """The paged kernel's plan (`paged_plan`, 8 KV heads): `want` blocks a
    KV head, a whole number a slot, at most MAX_SPLITS a slot and one wave
    of blocks; the longest slot alone would hold a tile in each of its
    share."""
    nx = paged_plan(live, slots, 8, per_sm)
    assert nx == want and nx % slots == 0
    n = nx // slots
    assert n <= 16 and (n == 1 or nx * 8 <= 132 * per_sm)
    n_tiles = -(-live // 64)
    per = -(-n_tiles // n)
    assert (n - 1) * per < n_tiles <= n * per


def test_non_cpu_tensors_never_take_the_plain_version():
    q = torch.empty(1, 1, 32, 64, device="meta")
    k = torch.empty(1, 64, 8, 64, device="meta")
    lengths = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_attend(q, k, k, lengths, 4)



@pytest.mark.parametrize("pos", [0, 63, 64, 255, 256, S - 1])
@pytest.mark.parametrize("H,KVH,Hd,Vd", [(4, 4, 24, 12), (2, 2, 192, 128), (8, 2, 32, 16)])
def test_mla_widths_match_reference_kernel(rng, pos, H, KVH, Hd, Vd):
    """V's head dim other than Q/K's (MLA: G = 1, the tiny deepseek_v2's
    (24, 12) and V2-Lite's (192, 128)), with the model's own softmax scale."""
    q, k, _ = _mk(rng, 2, H, KVH, Hd, S)
    v = rng.normal(size=(2, S, KVH, Vd)).astype(np.float32)
    scale = 1.3 * Hd**-0.5
    from dnet_tpu.ops.flash_decode import flash_decode_attend as ref_decode

    want = np.asarray(ref_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos), scale=scale))
    got = _attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos, scale=scale)
    assert got.shape == (2, 1, H, Vd)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
