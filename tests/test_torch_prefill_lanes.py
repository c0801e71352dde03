"""The prefill kernel's per-lane-positions form (the batched speculative
verify) against dnet_tpu's Pallas kernel, and the lane chunk attention
around it.

On the CPU the port's wrapper runs its plain version over per-lane masks;
the reference runs its real `_flash_kernel` in interpret mode
(DNET_FLASH_INTERPRET=1) under jax.vmap over lanes, each lane at its own
pos, as its batched engine's verify block calls it (dnet_tpu/core/batch.py
:304-343).  Its kernel gate takes T >= 8, so a T = 5 chunk is held to the
reference's dense causal attention per lane.  f32 within 2e-5, the repo's
kernel tolerance, at the three width pairs (64, 64), (128, 128) and MLA's
(192, 128).  `lane_chunk_attend` writes only the speculating lanes' rows,
codes and scales together, and each lane's output equals the single-lane
cached attention at its start."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu.ops.attention import attend, causal_mask
from dnet_tpu_torch.core.kvcache import KVConfig, init_cache, layer_slices, write_kv
from dnet_tpu_torch.ops.attention import LaneChunk, cached_attend, lane_chunk_attend
from dnet_tpu_torch.ops.flash_attention import flash_attend_causal, flash_prefill

pytestmark = pytest.mark.core

TOL = dict(atol=2e-5, rtol=2e-5)
WIDTHS = [(64, 64), (128, 128), (192, 128)]


@pytest.fixture(autouse=True)
def _force_kernel(monkeypatch):
    # the reference's REAL kernel via the pallas interpreter on CPU
    monkeypatch.setenv("DNET_FLASH_INTERPRET", "1")


def _case(rng, B, T, H, KVH, dqk, dv, S, sinks=False):
    q = rng.normal(size=(B, T, H, dqk)).astype(np.float32)
    k = rng.normal(size=(B, S, KVH, dqk)).astype(np.float32)
    v = rng.normal(size=(B, S, KVH, dv)).astype(np.float32)
    sk = rng.normal(size=(H,)).astype(np.float32) if sinks else None
    return q, k, v, sk


def _ref_lanes(q, k, v, starts, sinks=None, scale=None):
    """The reference's kernel vmapped over lanes, each at its own pos."""
    from dnet_tpu.ops.flash_attention import flash_attend_causal as ref_flash

    s = None if sinks is None else jnp.asarray(sinks)

    def one(qb, kb, vb, p):
        return ref_flash(qb[None], kb[None], vb[None], p, scale=scale, sinks=s)[0]

    return np.asarray(jax.vmap(one)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(starts, dtype=jnp.int32)))


@pytest.mark.parametrize("dqk,dv", WIDTHS)
@pytest.mark.parametrize("starts", [[0, 17, 56], [40, 40, 8]])
def test_lanes_match_reference_kernel(rng, dqk, dv, starts):
    """T = 8 (the kernel gate's least chunk), GQA G = 2, lanes at their own
    starts, the last one ending at the cache's last slot."""
    from dnet_tpu.ops.flash_attention import flash_eligible

    q, k, v, _ = _case(rng, 3, 8, 4, 2, dqk, dv, 64)
    assert flash_eligible(jnp.asarray(q[:1]), jnp.asarray(k[:1]), jnp.asarray(v[:1]))
    want = _ref_lanes(q, k, v, starts)
    got = flash_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), max(starts),
                        positions=torch.tensor(starts, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_lanes_with_sinks_and_scale_match_reference_kernel(rng):
    """gpt_oss-style sink logits and an explicit softmax scale (MLA's)."""
    q, k, v, sk = _case(rng, 2, 16, 4, 1, 64, 64, 128, sinks=True)
    starts = [5, 100]
    want = _ref_lanes(q, k, v, starts, sinks=sk, scale=0.11)
    got = flash_attend_causal(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 100, scale=0.11,
                              sinks=torch.from_numpy(sk), positions=torch.tensor(starts, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dqk,dv", WIDTHS)
def test_verify_chunk_matches_reference_dense(rng, dqk, dv):
    """The verify block's own shape, T = L + 1 = 5, below the reference
    kernel's gate: each lane against the reference's dense causal attention
    at its start."""
    q, k, v, _ = _case(rng, 4, 5, 8, 2, dqk, dv, 96)
    starts = [0, 31, 64, 91]
    got = flash_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), max(starts),
                        positions=torch.tensor(starts, dtype=torch.int32)).numpy()
    for b, p in enumerate(starts):
        want = attend(jnp.asarray(q[b : b + 1]), jnp.asarray(k[b : b + 1]), jnp.asarray(v[b : b + 1]),
                      mask=causal_mask(5, 96, p))
        np.testing.assert_allclose(got[b : b + 1], np.asarray(want), **TOL)


def test_lanes_form_checks_shapes():
    q, k, v = torch.zeros(2, 5, 4, 64), torch.zeros(2, 32, 2, 64), torch.zeros(2, 32, 2, 64)
    with pytest.raises(ValueError, match="positions"):
        flash_prefill(q, k, v, 3, positions=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="does not fit"):
        flash_prefill(q, k, v, 28, positions=torch.tensor([0, 28], dtype=torch.int32))


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("dqk,dv", [(64, 64), (192, 128)])
def test_lane_chunk_attend_writes_and_attends_per_lane(rng, bits, dqk, dv):
    """Lanes 0 and 2 of 3 speculate (T = 5 at their own starts): their rows
    are written, codes and scales together, lane 1's rows are untouched,
    and each speculating lane's output equals the single-lane cached
    attention (write_kv + the scalar form) at its start; a quantized cache
    reads its live prefix dequantized to f32."""
    B, T, H, KVH, S = 3, 5, 4, 2, 64
    cfg = KVConfig(n_layers=1, batch=B, max_seq=S, n_kv_heads=KVH, head_dim=dqk, dtype="float32",
                   v_head_dim=dv, quant_bits=bits)
    cache = init_cache(cfg, torch.device("cpu"))
    prefix = _case(rng, B, 40, H, KVH, dqk, dv, 40)
    write_kv(layer_slices(cache, 0), torch.from_numpy(prefix[1]), torch.from_numpy(prefix[2]), 0)
    q, k_new, v_new, _ = (torch.from_numpy(a) if a is not None else None for a in _case(rng, B, T, H, KVH, dqk, dv, T))
    starts = np.array([12, 0, 33])
    lanes = torch.tensor([0, 2])
    chunk = LaneChunk(lanes, torch.from_numpy(starts[[0, 2]])[:, None] + torch.arange(T),
                      torch.from_numpy(starts.astype(np.int32)), int(starts.max()))
    before = {n: t.clone() for n, t in cache.items()}
    kvs = layer_slices(cache, 0)
    out = lane_chunk_attend(q, k_new, v_new, kvs, chunk)
    for n, t in cache.items():
        assert torch.equal(t[:, 1], before[n][:, 1])  # the lane that does not speculate
    for b in (0, 2):
        single = {n: before[n][0, b : b + 1].clone() for n in cache}
        want, single = cached_attend(q[b : b + 1], k_new[b : b + 1], v_new[b : b + 1], single, int(starts[b]),
                                     None, causal=True)
        torch.testing.assert_close(out[b : b + 1], want, **TOL)
        for n in cache:
            assert torch.equal(cache[n][0, b], single[n][0])
