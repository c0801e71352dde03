"""The decode and paged kernels' tensor-core forms, on the CPU: which calls
take them, their grid, and their numerics against dnet_tpu's kernels.

A bf16 q over a bf16 cache or pool at head dim 128 with G = H / KVH >= 5
query heads a KV head runs the tensor-core form (csrc/mma.cuh): a block
holds 16 query rows (mma.sync's m), 4 key groups split every 64-key tile
by keys, 16 each (two warps a group, half the output columns apiece);
scores are bf16 q . k on the tensor cores, exact products summed in f32,
scaled after; P enters P V as hi + lo, two bf16 terms; the sums l come
from the unrounded p.  Every other call runs the CUDA-core form (the
decode kernel at head dim 128 in row groups of 4, the paged kernel of 8).

- (a) The dispatch table: the form, rows and row groups `decode_layout` and
  `paged_layout` pick (the wrappers launch what they return) for each
  (q dtype, cache dtype and bits, D, G).
- (b) The row-group grid at 16 rows lives in tests/test_torch_wide_group.py
  (`row_group_launch`, `paged_row_group_launch` at G = 7, 8, 16, 24).
- (c) `decode_mma_emulate` / `paged_mma_emulate` below write the tensor-core
  form's numerics out in plain PyTorch, key group by key group, and hold them to the
  reference's Pallas kernels in interpret mode (DNET_FLASH_INTERPRET=1; the
  LSE partials to its `_decode_emulate(..., with_lse=True)`) at G = 7, 8
  and 16 on bf16-representable inputs, within MMA_TOL: f32 for outputs kept
  in f32 (the LSE partials), bf16 for outputs rounded to bf16 (normalised
  decode, paged).  chip_smoke.py holds the kernels to the same MMA_TOL.
  The plain versions the wrappers run on the CPU stay f32, within 2e-5 of
  the reference at the same G (tests/test_flash_decode.py:41).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu_torch.ops.flash_decode import (
    MMA_TOL,
    NEG_INF,
    decode_layout,
    flash_decode_attend,
    flash_decode_lse,
)
from dnet_tpu_torch.ops.paged_attention import paged_attend, paged_layout
from tests.test_torch_decode_plan import _ref_lane, _ref_lse, split_tiles
from tests.test_torch_paged_plan import _case, split_plan

pytestmark = pytest.mark.core

TOL = dict(atol=2e-5, rtol=2e-5)
LOG2E = 1.4426950408889634
D = 128
S = 256
ROWS, KGROUPS, BK = 16, 4, 64
WK = BK // KGROUPS  # keys a key group folds of every tile


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DNET_FLASH_INTERPRET", "1")


# ---- (a) the dispatch table -----------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32
GROUPS = [1, 4, 5, 7, 8, 12, 16, 24]
# CUDA-core rows a block per G: the group rounded up to 1, 4 or 8; the
# decode kernel at head dim 128 never more than 4 (its GP = 8
# instantiation is not built there), the paged kernel 8 (16 lanes a key)
CORE_ROWS = {64: [1, 4, 8, 8, 8, 8, 8, 8], 128: [1, 4, 4, 4, 4, 4, 4, 4]}
PAGED_CORE_ROWS = [1, 4, 8, 8, 8, 8, 8, 8]
# (q dtype, cache dtype, bits) of each cache form
CACHES = {"bf16": (BF16, BF16, 0), "f32": (F32, F32, 0), "bf16 under f32": (F32, BF16, 0),
          "q8": (BF16, torch.int8, 8), "q4": (BF16, torch.uint8, 4)}


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("head_dim", [64, 128])
def test_dispatch_table(cache, head_dim):
    """bf16 over bf16 at head dim 128 and G >= 5: the tensor-core form, 16
    rows, ceil(G / 16) row groups (G = 24: two); every other call the
    CUDA-core rows (CORE_ROWS, PAGED_CORE_ROWS for the paged kernel, which
    takes bf16 and f32 pools)."""
    q_dtype, kv_dtype, bits = CACHES[cache]
    for G, core, paged_core in zip(GROUPS, CORE_ROWS[head_dim], PAGED_CORE_ROWS):
        mma = cache == "bf16" and head_dim == 128 and G >= 5
        want = (True, 16, -(-G // 16)) if mma else (False, core, -(-G // core))
        assert decode_layout(q_dtype, kv_dtype, bits, head_dim, head_dim, G) == want, (cache, head_dim, G)
        assert decode_layout(q_dtype, kv_dtype, bits, head_dim, head_dim, G, rotating=True)[0] is False
        if not bits:
            want = (True, 16, -(-G // 16)) if mma else (False, paged_core, -(-G // paged_core))
            assert paged_layout(q_dtype, kv_dtype, head_dim, G) == want, (cache, head_dim, G)
    # MLA's (192, 128) never takes the tensor-core form
    assert decode_layout(BF16, BF16, 0, 192, 128, 16) == (False, 8, 2)


# ---- (c) the tensor-core numerics, emulated --------------------------------

def _split_bf16(p: torch.Tensor) -> tuple:
    """p as hi + lo, two bf16 terms, in f32."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def _fold_rows(qr, kf, vf, keys, live, sl2, p_lo=True):
    """One block's key groups over its keys (a list of its tiles' first
    keys), as mma.cuh's fold_tile and block_state: qr [16, D] bf16 rows as
    f32, kf / vf [keys, D] f32 (rows past `live` zero); returns the block's
    (m, l, acc) in log2 units.  `p_lo` False: P enters P V as its bf16
    rounding alone (the prefill kernel's choice), for comparison."""
    states = []
    for w in range(KGROUPS):
        m, l, o = torch.full((ROWS,), NEG_INF), torch.zeros(ROWS), torch.zeros(ROWS, vf.shape[-1])
        for t0 in keys:
            j = torch.arange(t0 + w * WK, t0 + (w + 1) * WK)
            if int(j[0]) >= live:
                continue  # a key group whose keys are all past the live slots skips the tile
            ok = j < live
            rows = j.clamp(max=kf.shape[0] - 1)
            kt = torch.where(ok[:, None], kf[rows], 0.0)
            vt = torch.where(ok[:, None], vf[rows], 0.0)
            s = torch.where(ok, (qr @ kt.T) * sl2, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[:, None])
            hi, lo = _split_bf16(p)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[:, None] + hi @ vt + (lo @ vt if p_lo else 0.0)
            m = m_new
        states.append((m, l, o))
    return _merge(states)


def _merge(states):
    m = torch.stack([s[0] for s in states]).amax(dim=0)
    w = [torch.exp2(s[0] - m) for s in states]
    return m, sum(wi * s[1] for wi, s in zip(w, states)), sum(wi[:, None] * s[2] for wi, s in zip(w, states))


def decode_mma_emulate(q, k, v, lengths, n_split, scale=None, sinks=None, with_lse=False, p_lo=True):
    """csrc/flash_decode.cu's tensor-core form in plain PyTorch: bf16 q
    [B, 1, H, D], k / v [B, S, KVH, D]; per (lane, KV head, row group of
    16) n_split blocks over the lane's live tiles, merged with one
    log-sum-exp in log2 units.  Returns the normalised output (f32, before
    the kernel rounds it to bf16), or with `with_lse` the LSE partials
    (acc, m, l)."""
    B, _, H, Dq = q.shape
    KVH = k.shape[2]
    G = H // KVH
    sl2 = (Dq**-0.5 if scale is None else scale) * LOG2E
    out = torch.zeros(B, H, v.shape[-1])
    m_out, l_out = torch.full((B, H), NEG_INF), torch.zeros(B, H)
    for b in range(B):
        live = min(int(lengths[b]), k.shape[1])
        for h in range(KVH):
            kf, vf = k[b, :, h].float(), v[b, :, h].float()
            for r in range(-(-G // ROWS)):
                h0, gb = h * G + r * ROWS, min(ROWS, G - r * ROWS)
                qr = torch.zeros(ROWS, Dq)
                qr[:gb] = q[b, 0, h0:h0 + gb].float()
                blocks = [_fold_rows(qr, kf, vf, [t * BK for t in split_tiles(live, n_split, s)], live, sl2, p_lo)
                          for s in range(n_split)]
                m, l, acc = _merge(blocks)
                m_out[b, h0:h0 + gb], l_out[b, h0:h0 + gb], out[b, h0:h0 + gb] = m[:gb], l[:gb], acc[:gb]
    if with_lse:
        m_nat = torch.where(m_out == NEG_INF, NEG_INF, m_out / LOG2E)
        return out.reshape(B, 1, H, -1), m_nat.reshape(B, KVH, G), l_out.reshape(B, KVH, G)
    sink = torch.full((H,), NEG_INF) if sinks is None else sinks.float() * LOG2E
    m_fin = torch.maximum(m_out, sink)
    corr = torch.exp2(m_out - m_fin)
    l_fin = torch.clamp(l_out * corr + torch.exp2(sink - m_fin), min=1e-30)
    return (out * (corr / l_fin)[..., None]).reshape(B, 1, H, -1)


def paged_mma_emulate(q, k_pool, v_pool, tables, pos, k_new, v_new, nx):
    """csrc/paged_attention.cu's tensor-core form in plain PyTorch: each
    slot's live rows through its table, split as `split_plan` over nx
    blocks, the key groups' fold as the decode form's, the new row (its score
    bf16 products summed in f32, scaled after) folded in the merge.
    Returns the output in f32, before the kernel rounds it to bf16."""
    B, _, H, Dq = q.shape
    _, bt, KVH, _ = k_pool.shape
    nb = tables.shape[1]
    G = H // KVH
    sl2 = Dq**-0.5 * LOG2E
    splits, _, _ = split_plan(pos.tolist(), nx, BK, nb * bt)
    kf, vf = k_pool.float().reshape(-1, KVH, Dq), v_pool.float().reshape(-1, KVH, Dq)
    out = torch.zeros(B, H, Dq)
    for b in range(B):
        live = min(int(pos[b]), nb * bt)
        phys = torch.tensor([int(tables[b, j // bt]) * bt + j % bt for j in range(live)], dtype=torch.long)
        for h in range(KVH):
            kl, vl = kf[phys, h], vf[phys, h]
            for r in range(-(-G // ROWS)):
                h0, gb = h * G + r * ROWS, min(ROWS, G - r * ROWS)
                qr = torch.zeros(ROWS, Dq)
                qr[:gb] = q[b, 0, h0:h0 + gb].float()
                blocks = [_fold_rows(qr, kl, vl, [t * BK for t in split_tiles(live, splits[b], s)], live, sl2)
                          for s in range(splits[b])]
                sn = (qr @ k_new[b, h].float()) * sl2
                m, l, acc = _merge([(sn, torch.ones(ROWS), v_new[b, h].float()[None, :].expand(ROWS, -1))] + blocks)
                out[b, h0:h0 + gb] = (acc / l[:, None])[:gb]
    return out.reshape(B, 1, H, Dq)


def _bf16_inputs(rng, B, H, KVH, S_=S):
    """q, k, v drawn normal and rounded to bf16 (numpy f32 arrays holding
    bf16 values: the reference computes in f32 on exactly what the kernel
    reads)."""
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16).float().numpy()  # noqa: E731
    return f(B, 1, H, D), f(B, S_, KVH, D), f(B, S_, KVH, D)


def _bf16(a):
    return torch.from_numpy(np.asarray(a)).to(torch.bfloat16)


LENGTHS = [1, 63, 64, 65, 200, S]


@pytest.mark.parametrize("G", [7, 8, 16])
@pytest.mark.parametrize("n_split", [1, 3, 16])
def test_decode_mma_emulation_matches_reference_kernel(rng, G, n_split):
    """Normalised decode: the emulation against the reference's kernel per
    lane (tile edges, mid-tile, the last slot), within MMA_TOL[f32] in f32
    and MMA_TOL[bf16] once rounded to bf16 as the kernel writes it; an idle
    lane gives zeros."""
    q, k, v = _bf16_inputs(rng, len(LENGTHS) + 1, 2 * G, 2)
    lengths = LENGTHS + [0]
    got = decode_mma_emulate(_bf16(q), _bf16(k), _bf16(v), lengths, n_split)
    assert not got[-1].any()
    for b, length in enumerate(LENGTHS):
        want = _ref_lane(q[b:b + 1], {"k": k[b:b + 1], "v": v[b:b + 1]}, length - 1)
        err = np.abs(got[b:b + 1].numpy() - want).max()
        assert err <= MMA_TOL[torch.float32], (G, length, err)
        err16 = np.abs(got[b:b + 1].to(torch.bfloat16).float().numpy() - want).max()
        assert err16 <= MMA_TOL[torch.bfloat16], (G, length, err16)


@pytest.mark.parametrize("G", [7, 8, 16])
def test_p_as_hi_plus_lo_keeps_the_f32_tolerance(rng, G):
    """Why P enters P V as hi + lo: against the reference, the f32 output
    stays within 1e-5 with it (about 1e-6 here) and misses MMA_TOL[f32]
    with P rounded to bf16 alone (about 1e-3 here)."""
    q, k, v = _bf16_inputs(rng, len(LENGTHS), 2 * G, 2)
    want = np.concatenate([_ref_lane(q[b:b + 1], {"k": k[b:b + 1], "v": v[b:b + 1]}, n - 1)
                           for b, n in enumerate(LENGTHS)])
    errs = {p_lo: np.abs(decode_mma_emulate(_bf16(q), _bf16(k), _bf16(v), LENGTHS, 1, p_lo=p_lo).numpy() - want).max()
            for p_lo in (True, False)}
    assert errs[True] <= 1e-5 < MMA_TOL[torch.float32] < errs[False], errs


@pytest.mark.parametrize("G", [7, 8, 16])
def test_decode_mma_emulation_sinks(rng, G):
    """The sinks fold once into the denominator, in log2 units as the
    kernel's epilogue."""
    q, k, v = _bf16_inputs(rng, 2, 2 * G, 2)
    sinks = rng.normal(size=(2 * G,)).astype(np.float32)
    got = decode_mma_emulate(_bf16(q), _bf16(k), _bf16(v), [130, S], 3, sinks=torch.from_numpy(sinks))
    for b, length in enumerate([130, S]):
        want = _ref_lane(q[b:b + 1], {"k": k[b:b + 1], "v": v[b:b + 1]}, length - 1, sinks=sinks)
        assert np.abs(got[b:b + 1].numpy() - want).max() <= MMA_TOL[torch.float32]


@pytest.mark.parametrize("G", [7, 8, 16])
@pytest.mark.parametrize("n_split", [1, 16])
def test_lse_mma_emulation_matches_reference_emulation(rng, G, n_split):
    """One sp rank's partials: m within MMA_TOL[f32], l relative to itself,
    acc / l; an empty lane exactly (0, NEG_INF, 0)."""
    H, lengths = 2 * G, [200, 0, S, 1]
    q, k, v = _bf16_inputs(rng, len(lengths), H, 2)
    acc, m, l = decode_mma_emulate(_bf16(q), _bf16(k), _bf16(v), lengths, n_split, with_lse=True)
    tol = MMA_TOL[torch.float32]
    for b, live in enumerate(lengths):
        w_acc, w_m, w_l = _ref_lse(q[b:b + 1], {"k": k[b:b + 1], "v": v[b:b + 1]}, live, None, S)
        if not live:
            assert (m[b] == NEG_INF).all() and (l[b] == 0).all() and (acc[b] == 0).all()
            continue
        assert np.abs(m[b:b + 1].numpy() - w_m).max() <= tol
        assert (np.abs(l[b:b + 1].numpy() - w_l) / w_l).max() <= tol
        norm_got = acc[b:b + 1].numpy() / l[b:b + 1].numpy().reshape(1, 1, H, 1)
        assert np.abs(norm_got - w_acc / w_l.reshape(1, 1, H, 1)).max() <= tol


@pytest.mark.parametrize("G", [7, 8, 16])
@pytest.mark.parametrize("per_slot", [1, 3])
def test_paged_mma_emulation_matches_reference_kernel(G, per_slot):
    """Ragged slots through page tables (a slot at pos 0, block edges, dead
    entries at a NaN block) against the reference's interpret-mode paged
    kernel: MMA_TOL[f32] in f32, MMA_TOL[bf16] rounded to bf16."""
    from dnet_tpu.ops.paged_attention import paged_attend as ref_paged_attend

    case = list(_case(G, 8, [0, 5, 64, 130, 200], H=2 * G, KVH=2, D=D, cap=208))
    for i in (0, 1, 2, 5, 6):  # q, the pools and the new rows as bf16 values
        case[i] = torch.from_numpy(case[i]).to(torch.bfloat16).float().numpy()
    want = np.asarray(ref_paged_attend(*(jnp.asarray(a) for a in case), impl="interpret"))
    t = [torch.from_numpy(np.asarray(a)) for a in case]
    got = paged_mma_emulate(t[0].to(torch.bfloat16), t[1].to(torch.bfloat16), t[2].to(torch.bfloat16), t[3], t[4],
                            t[5].to(torch.bfloat16), t[6].to(torch.bfloat16), nx=per_slot * 5)
    assert np.abs(got.numpy() - want).max() <= MMA_TOL[torch.float32]
    assert np.abs(got.to(torch.bfloat16).float().numpy() - want).max() <= MMA_TOL[torch.bfloat16]


@pytest.mark.parametrize("G", [7, 8, 16])
def test_plain_versions_stay_f32_at_head_dim_128(rng, G):
    """What the wrappers run on the CPU at these groups: f32 within 2e-5
    of the reference's kernels (decode, LSE, paged)."""
    q, k, v = _bf16_inputs(rng, 3, 2 * G, 2)
    lengths = [65, 0, S]
    got = flash_decode_attend(*(torch.from_numpy(a) for a in (q, k, v)), torch.tensor(lengths, dtype=torch.int32),
                              S).numpy()
    assert not got[1].any()
    for b in (0, 2):
        want = _ref_lane(q[b:b + 1], {"k": k[b:b + 1], "v": v[b:b + 1]}, lengths[b] - 1)
        np.testing.assert_allclose(got[b:b + 1], want, **TOL)
    acc, m, l = flash_decode_lse(*(torch.from_numpy(a) for a in (q, k, v)), torch.tensor(lengths, dtype=torch.int32),
                                 S)
    w_acc, w_m, w_l = _ref_lse(q[2:3], {"k": k[2:3], "v": v[2:3]}, S, None, S)
    np.testing.assert_allclose(m[2:3].numpy(), w_m, **TOL)
    np.testing.assert_allclose(l[2:3].numpy(), w_l, **TOL)
    from dnet_tpu.ops.paged_attention import paged_attend as ref_paged_attend

    case = _case(G + 1, 8, [0, 70, 200], H=2 * G, KVH=2, D=D, cap=208)
    want = np.asarray(ref_paged_attend(*(jnp.asarray(a) for a in case), impl="interpret"))
    np.testing.assert_allclose(paged_attend(*(torch.from_numpy(np.asarray(a)) for a in case)).numpy(), want, **TOL)
