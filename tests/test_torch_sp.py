"""The port's sequence-parallel ops against dnet_tpu's.

The same numpy inputs go through the reference inside `shard_map` over two
(or four) of the 8 forced CPU devices (tests/conftest.py), with
DNET_FLASH_INTERPRET=1 so its sp decode runs the kernel's jnp tile-fold
emulation as its own tests run it (tests/test_flash_mesh.py), and through
the port with every rank on the CPU (plain versions).

- the decode kernel's LSE form: m and l within 2e-5 in f32 and acc within
  2e-5 relative to l, the kernel tolerance of tests/test_flash_decode.py:41,
  against `_decode_emulate(..., with_lse=True)`, ranks with live slots and a
  rank wholly past pos included;
- `sp_flash_decode_attend` / `sp_decode_attend` / `ring_attend`: 2e-5, as
  tests/test_flash_mesh.py and tests/test_ring_attention.py hold the
  reference;
- `write_kv_sp`: the shards equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from dnet_tpu.utils.jax_compat import shard_map
from dnet_tpu_torch.core.kvcache import KVConfig, init_cache_sp, write_kv_sp
from dnet_tpu_torch.ops.attention import sp_causal_mask, sp_sliding_window_mask
from dnet_tpu_torch.ops.flash_decode import (
    NEG_INF,
    flash_decode_lse,
    flash_decode_lse_plain,
    rank_live,
    sp_lengths,
)
from dnet_tpu_torch.ops.ring_attention import ring_attend, sp_decode_attend, sp_flash_decode_attend
from dnet_tpu_torch.parallel.mesh import SpGroup

pytestmark = [pytest.mark.core, pytest.mark.parallel]

TOL = dict(atol=2e-5, rtol=2e-5)
B, S, H, KVH, HD = 1, 64, 4, 2, 16


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DNET_FLASH_INTERPRET", "1")


def _mesh(devices, n=2):
    return Mesh(np.array(devices[:n]), ("sp",))


def _inputs(seed, T=1, S=S, H=H, KVH=KVH, HD=HD, B=B):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(B, T, H, HD), f(B, S, KVH, HD), f(B, S, KVH, HD)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _group(n=2):
    return SpGroup(["cpu"] * n)


@pytest.mark.parametrize("pos,offset,s_local", [(10, 0, 32), (45, 32, 32), (45, 0, 32), (20, 32, 32),
                                                (0, 0, 64), (200, 128, 128), (130, 128, 128)])
def test_lse_plain_matches_reference_emulation(pos, offset, s_local):
    """One rank's partials: its shard's slots, its offset, the port's
    lengths from the same (pos, offset).  (20, 32) is a rank wholly past pos:
    m = NEG_INF, l = 0, acc = 0 on both sides."""
    from dnet_tpu.ops.flash_attention import _pick_tile
    from dnet_tpu.ops.flash_decode import _decode_emulate

    q, k, v = _inputs(pos + offset, S=s_local)
    G = H // KVH
    scalars = jnp.asarray([pos, offset], jnp.int32)
    sinks = jnp.full((KVH, G), NEG_INF, jnp.float32)
    want = _decode_emulate(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scalars, sinks, G=G,
                           scale=HD**-0.5, bk=_pick_tile(s_local, 256), window=0, rotating=False,
                           with_lse=True)
    live = min(max(pos + 1 - offset, 0), s_local)
    lengths = torch.full((B,), live, dtype=torch.int32)
    got = flash_decode_lse(_t(q), _t(k), _t(v), lengths, live)
    acc, m, l = (np.asarray(x) for x in want)
    np.testing.assert_allclose(got[1].numpy(), m, **TOL)
    np.testing.assert_allclose(got[2].numpy(), l, **TOL)
    # acc relative to l (acc / l is the rank's attention output)
    scale_l = np.maximum(l, 1e-30).reshape(B, 1, H, 1)
    np.testing.assert_allclose(got[0].numpy() / scale_l, acc / scale_l, **TOL)
    if live == 0:
        assert (got[1] == NEG_INF).all() and (got[2] == 0).all() and (got[0] == 0).all()
        assert (m == NEG_INF).all() and (l == 0).all()


def test_lse_lengths_per_lane_and_rank():
    """sp_lengths: each rank's live slot count per lane, and the plain LSE
    form honours each lane's own length."""
    assert [rank_live(p, r, 32) for p in (0, 31, 32, 63) for r in (0, 1)] == [1, 0, 32, 0, 32, 1, 32, 32]
    assert [t.tolist() for t in sp_lengths(2, 40, 32, ["cpu", "cpu"])] == [[32, 32], [9, 9]]
    q, k, v = _inputs(3, B=2)
    lengths = torch.tensor([5, 0], dtype=torch.int32)
    acc, m, l = flash_decode_lse_plain(_t(q), _t(k), _t(v), lengths)
    a0, m0, l0 = flash_decode_lse_plain(_t(q)[:1], _t(k)[:1], _t(v)[:1], lengths[:1])
    assert torch.equal(acc[:1], a0) and torch.equal(m[:1], m0) and torch.equal(l[:1], l0)
    assert (m[1] == NEG_INF).all() and (l[1] == 0).all() and (acc[1] == 0).all()


def _ref_sp_flash(q, k, v, pos, devices, sinks=None, scale=None):
    from dnet_tpu.ops.flash_decode import sp_flash_decode_attend as ref

    def body(q, k, v):
        return ref(q, k, v, jnp.int32(pos), "sp", sinks=sinks, scale=scale)

    return np.asarray(shard_map(body, mesh=_mesh(devices), in_specs=(P(), P(None, "sp"), P(None, "sp")),
                                out_specs=P())(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("pos", [10, 45, 63])
@pytest.mark.parametrize("variant", ["plain", "sinks", "scale"])
def test_sp_flash_decode_matches_reference(eight_devices, pos, variant):
    """Positions 10 (rank 1 wholly past pos), 45 and 63 in S = 64 over two
    ranks, with sinks folded once after the combine, or a custom scale."""
    q, k, v = _inputs(pos)
    rng = np.random.default_rng(99)
    sinks = rng.normal(size=(H,)).astype(np.float32) if variant == "sinks" else None
    scale = 2.5 * HD**-0.5 if variant == "scale" else None
    want = _ref_sp_flash(q, k, v, pos, eight_devices, None if sinks is None else jnp.asarray(sinks), scale)
    sp = _group()
    ks, vs = list(_t(k).split(S // 2, dim=1)), list(_t(v).split(S // 2, dim=1))
    got = sp_flash_decode_attend(_t(q), [x.contiguous() for x in ks], [x.contiguous() for x in vs],
                                 sp_lengths(B, pos, S // 2, sp.devices),
                                 [rank_live(pos, r, S // 2) for r in range(2)], sp,
                                 sinks=None if sinks is None else _t(sinks), scale=scale)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("T,pos", [(1, 10), (1, 45), (16, 20), (24, 40)])
@pytest.mark.parametrize("variant", ["plain", "sinks", "scale"])
def test_sp_decode_attend_matches_reference(eight_devices, T, pos, variant):
    """The dense sp attention under each rank's sp_causal_mask: decode rows
    and prompt chunks (16 rows at 20 cross the shard boundary at 32)."""
    from dnet_tpu.ops.attention import sp_causal_mask as ref_mask
    from dnet_tpu.ops.ring_attention import sp_decode_attend as ref

    q, k, v = _inputs(T * 100 + pos, T=T)
    rng = np.random.default_rng(7)
    sinks = rng.normal(size=(H,)).astype(np.float32) if variant == "sinks" else None
    scale = 0.3 if variant == "scale" else None
    jsinks = None if sinks is None else jnp.asarray(sinks)

    def body(k, v):
        mask = ref_mask(T, S // 2, jnp.int32(pos), "sp")
        return ref(jnp.asarray(q), k, v, mask, "sp", sinks=jsinks, scale=scale)

    want = np.asarray(shard_map(body, mesh=_mesh(eight_devices), in_specs=(P(None, "sp"), P(None, "sp")),
                                out_specs=P())(jnp.asarray(k), jnp.asarray(v)))
    masks = [sp_causal_mask(T, S // 2, pos, r) for r in range(2)]
    got = sp_decode_attend(_t(q), list(_t(k).split(S // 2, dim=1)), list(_t(v).split(S // 2, dim=1)), masks,
                           _group(), sinks=None if sinks is None else _t(sinks), scale=scale)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("rank", [0, 1])
def test_sp_masks_match_reference(eight_devices, rank):
    from dnet_tpu.ops.attention import sp_causal_mask as ref_causal
    from dnet_tpu.ops.attention import sp_sliding_window_mask as ref_sliding

    def body(_):
        return (ref_causal(8, 16, jnp.int32(12), "sp")[None],
                ref_sliding(8, 16, jnp.int32(12), 5, "sp")[None])

    causal, sliding = shard_map(body, mesh=_mesh(eight_devices), in_specs=(P("sp"),),
                                out_specs=(P("sp"), P("sp")))(jnp.zeros(2))
    assert np.array_equal(sp_causal_mask(8, 16, 12, rank).numpy(), np.asarray(causal)[rank])
    assert np.array_equal(sp_sliding_window_mask(8, 16, 12, 5, rank).numpy(), np.asarray(sliding)[rank])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H_,KVH_,HD_", [(4, 2, 16), (8, 2, 8)])
def test_ring_attend_matches_reference(eight_devices, causal, H_, KVH_, HD_):
    """Full ring attention over 4 ranks, causal and not, with GQA."""
    from dnet_tpu.ops.ring_attention import ring_attend as ref

    n, T = 4, 32
    q, k, v = _inputs(5, T=T, S=T, H=H_, KVH=KVH_, HD=HD_)
    positions = np.arange(T, dtype=np.int32)
    fn = shard_map(lambda qb, kb, vb, qp, kp: ref(qb, kb, vb, qp, kp, "sp", causal=causal),
                   mesh=_mesh(eight_devices, n),
                   in_specs=(P(None, "sp"), P(None, "sp"), P(None, "sp"), P("sp"), P("sp")),
                   out_specs=P(None, "sp"))
    want = np.asarray(fn(*(jnp.asarray(a) for a in (q, k, v, positions, positions))))
    blocks = [list(_t(a).split(T // n, dim=1)) for a in (q, k, v)]
    pos_blocks = list(torch.arange(T).split(T // n))
    got = ring_attend(*blocks, pos_blocks, pos_blocks, _group(n), causal=causal)
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), want, **TOL)


@pytest.mark.parametrize("form", ["float32", "bfloat16", "q8"])
@pytest.mark.parametrize("pos,T", [(5, 1), (40, 1), (25, 16), (0, 64), (48, 16)])
def test_write_kv_sp_matches_reference(eight_devices, form, pos, T):
    """A decode token on each rank, a chunk across the shard boundary at 32,
    a whole-cache chunk and one up to the end: equal shards bit for bit
    (codes and scales under q8)."""
    from dnet_tpu.core.kvcache import write_kv_sp as ref

    rng = np.random.default_rng(pos * 7 + T)
    k_new, v_new = (rng.normal(size=(B, T, KVH, HD)).astype(np.float32) for _ in range(2))
    bits = 8 if form == "q8" else 0
    dtype = "float32" if form == "q8" else form
    ranks = init_cache_sp(KVConfig(1, B, S, KVH, HD, dtype=dtype, quant_bits=bits), ["cpu", "cpu"])
    # nonzero old contents: a write must leave other slots alone
    for c in ranks:
        for name, t in c.items():
            t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).to(t.dtype)
                    if t.is_floating_point() else torch.from_numpy(rng.integers(-9, 9, t.shape)).to(t.dtype))
    layer = [{n: t[0] for n, t in c.items()} for c in ranks]
    old = {n: np.concatenate([_np(c[n]) for c in layer], axis=1) for n in layer[0]}

    def body(kvs):
        return ref(kvs, jnp.asarray(k_new), jnp.asarray(v_new), jnp.int32(pos), "sp")

    ref_kvs = {n: jnp.asarray(a).astype(jnp.bfloat16) if dtype == "bfloat16" and n in ("k", "v") else jnp.asarray(a)
               for n, a in old.items()}
    want = shard_map(body, mesh=_mesh(eight_devices), in_specs=(P(None, "sp"),),
                     out_specs=P(None, "sp"))(ref_kvs)
    write_kv_sp(layer, _t(k_new), _t(v_new), pos)
    for n in layer[0]:
        got = np.concatenate([_np(c[n]) for c in layer], axis=1)
        assert np.array_equal(got, np.asarray(want[n]).astype(got.dtype)), n  # bf16 -> f32 is exact


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
