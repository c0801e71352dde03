"""The port's single-device MoE dispatch against dnet_tpu/ops/moe.py.

The same numpy router outputs go through both: queue positions must be
equal, buffers and combined outputs within f32 1e-5.  Capacity factor 1.25
drops tokens routed past an expert's capacity (the routing below is skewed
so that some expert overflows); a factor <= 0 is the exact no-drop
capacity, where dispatch equals the dense every-token-x-every-expert sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu.ops import moe as ref
from dnet_tpu_torch.ops import moe

pytestmark = pytest.mark.core

TOL = dict(atol=1e-5, rtol=1e-5)
E, K, D = 4, 2, 8


def _routing(rng, N, skew=True):
    """top_idx [N, K] of distinct experts per token (expert 0 over-picked
    when skewed) and softmaxed top_w [N, K]."""
    p = np.array([0.55, 0.15, 0.15, 0.15]) if skew else None
    top_idx = np.stack([rng.choice(E, size=K, replace=False, p=p) for _ in range(N)]).astype(np.int32)
    w = rng.normal(size=(N, K)).astype(np.float32)
    top_w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    return top_idx, top_w.astype(np.float32)


@pytest.mark.parametrize("N", [1, 5, 33])
def test_route_positions_equal(rng, N):
    top_idx, _ = _routing(rng, N)
    top_idx[0, 1] = E  # a sentinel slot gets position 0
    want = np.asarray(ref.route_positions(jnp.asarray(top_idx), E))
    got = moe.route_positions(torch.from_numpy(top_idx), E).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("capacity", [1, 3, 40])
def test_scatter_and_gather_match(rng, capacity):
    N = 20
    top_idx, top_w = _routing(rng, N)
    flat = rng.normal(size=(N, D)).astype(np.float32)
    pos_r = ref.route_positions(jnp.asarray(top_idx), E)
    pos_p = moe.route_positions(torch.from_numpy(top_idx), E)
    want = np.asarray(ref.scatter_to_experts(jnp.asarray(flat), jnp.asarray(top_idx), pos_r, E, capacity))
    got = moe.scatter_to_experts(torch.from_numpy(flat), torch.from_numpy(top_idx), pos_p, E, capacity)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ye = rng.normal(size=(E, capacity, D)).astype(np.float32)
    want = np.asarray(ref.gather_from_experts(jnp.asarray(ye), jnp.asarray(top_idx), pos_r, jnp.asarray(top_w)))
    got = moe.gather_from_experts(torch.from_numpy(ye), torch.from_numpy(top_idx), pos_p, torch.from_numpy(top_w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _ffns(rng):
    """The same per-expert affine FFN in both frameworks: [E, C, D] -> [E, C, D]."""
    w = rng.normal(size=(E, D, D)).astype(np.float32) * 0.3
    b = rng.normal(size=(E, D)).astype(np.float32) * 0.1
    ref_ffn = lambda xe: jnp.einsum("ecd,edf->ecf", xe, jnp.asarray(w)) + jnp.asarray(b)[:, None]  # noqa: E731
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    port_ffn = lambda xe: torch.bmm(xe, tw) + tb[:, None]  # noqa: E731
    return ref_ffn, port_ffn, w, b


@pytest.mark.parametrize("factor", [1.25, 0.0, -1.0])
@pytest.mark.parametrize("N", [3, 40])
def test_moe_dispatch_matches(rng, factor, N):
    top_idx, top_w = _routing(rng, N)
    flat = rng.normal(size=(N, D)).astype(np.float32)
    ref_ffn, port_ffn, w, b = _ffns(rng)
    C = moe.expert_capacity(N, E, K, factor)
    assert C == ref.expert_capacity(N, E, K, factor)
    want = np.asarray(ref.moe_dispatch(jnp.asarray(flat), jnp.asarray(top_idx), jnp.asarray(top_w), ref_ffn, E, C))
    got = moe.moe_dispatch(torch.from_numpy(flat), torch.from_numpy(top_idx), torch.from_numpy(top_w),
                           port_ffn, E, C)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dense = np.einsum("nk,nkd->nd", top_w, np.einsum("nd,nkdf->nkf", flat, w[top_idx]) + b[top_idx])
    counts = np.bincount(top_idx.reshape(-1), minlength=E)
    if factor <= 0:
        assert C == N
        np.testing.assert_allclose(got.numpy(), dense, atol=1e-4, rtol=1e-4)
    elif counts.max() > C:  # some slot was dropped: dispatch is not the dense sum
        assert not np.allclose(got.numpy(), dense, atol=1e-4)


def test_moe_apply_paths(rng):
    """moe_apply routes dispatch and a2a (no mesh) through the capacity
    dispatch and dense through the model's closure, as the reference does."""
    N = 40
    top_idx, top_w = _routing(rng, N, skew=False)
    flat = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    _, port_ffn, _, _ = _ffns(rng)
    args = (flat, torch.from_numpy(top_idx), torch.from_numpy(top_w), port_ffn, E, 0.0, K)
    sentinel = torch.full((N, D), 7.0)
    torch.testing.assert_close(moe.moe_apply("dense", *args, lambda: sentinel), sentinel)
    via_dispatch = moe.moe_apply("dispatch", *args, lambda: sentinel)
    torch.testing.assert_close(moe.moe_apply("a2a", *args, lambda: sentinel), via_dispatch)
    torch.testing.assert_close(moe.moe_apply("auto", *args, lambda: sentinel), via_dispatch)  # N >= 2E


@pytest.mark.parametrize("impl,n,want", [
    ("auto", 1, "dense"), ("auto", 15, "dense"), ("auto", 63, "dense"), ("auto", 64, "dispatch"),
    ("dense", 64, "dense"), ("dispatch", 1, "dispatch"), ("a2a", 4, "a2a"),
])
def test_resolve_moe_impl_matches(impl, n, want):
    """One device (the reference with ranks=1)."""
    assert moe.resolve_moe_impl(impl, n, 32) == ref.resolve_moe_impl(impl, n, 32, 1) == want


def test_unknown_impl_fails_fast():
    with pytest.raises(ValueError, match="unknown moe_impl"):
        moe.resolve_moe_impl("desne", 4, 32)
    with pytest.raises(ValueError, match="unknown moe_impl"):
        ref.resolve_moe_impl("desne", 4, 32, 1)
