"""The hop codec's one-launch norms + top-k (`column_topk`) on the CPU.

`column_topk_plain` (the plain norms, `topk_columns`, the packed mask) is
held against dnet_tpu's send side (`column_l2_norms`, `jax.lax.top_k`, the
sort and the mask of `_wire_sparse_impl`) on the same numpy inputs: ties,
keep = 1 and keep = C, gpt-oss-20b's C = 2880 and NaN / inf columns.  The
inputs are small integers, so every norm is exact in f32 whatever the
order of its sums and both sides see the same bits (ties included).

The CUDA kernel (csrc/column_ops.cu `norms_topk_kernel`) runs only on the
card; here a numpy emulation of its walk (the splits of `norms_split`, each
warp's rows, the warps' sums in warp order, the partials in split order,
each product and sum rounded on its own; then the radix select over the
norms' f32 bits and the compaction by prefix sums over the threads' runs)
is held bit for bit against `topk_columns` and `pack_mask` of its own
norms, and its norms within 2e-5 relative of the plain version's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu.compression import ops as ref_ops
from dnet_tpu_torch.compression import ops
from dnet_tpu_torch.compression.wire import compress_tensor

NTHREADS, WARPS = 256, 8


def _ref_select(x: np.ndarray, keep: int):
    """dnet_tpu's send-side selection: (norms, ascending idx, mask bytes)."""
    norms = ref_ops.column_l2_norms(jnp.asarray(x))
    _, idx = jax.lax.top_k(norms, keep)
    idx = np.sort(np.asarray(idx))
    mask = np.zeros(x.shape[1], dtype=bool)
    mask[idx] = True
    return np.asarray(norms), idx.astype(np.int32), np.packbits(mask)


def _int_inputs(R, C, seed, tie_cols=0):
    """Small integers (exact norms), with `tie_cols` columns copied from
    others and a few all-zero columns: ties at every rank."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-6, 7, size=(R, C)).astype(np.float32)
    if tie_cols:
        src = rng.integers(0, C, size=tie_cols)
        dst = rng.integers(0, C, size=tie_cols)
        x[:, dst] = x[:, src]
        x[:, rng.integers(0, C, size=3)] = 0.0
    return x


@pytest.mark.parametrize("R", [1, 7, 64])
@pytest.mark.parametrize("C", [8, 100, 2048, 2880])
@pytest.mark.parametrize("keep_of", ["1", "half", "all"])
def test_plain_matches_reference_selection(R, C, keep_of):
    keep = {"1": 1, "half": C // 2, "all": C}[keep_of]
    x = _int_inputs(R, C, seed=R + C, tie_cols=C // 4)
    want_norms, want_idx, want_mask = _ref_select(x, keep)
    for dtype in (torch.float32, torch.bfloat16):  # small integers are exact in bf16
        xt = torch.from_numpy(x).to(dtype)
        assert np.array_equal(ops.column_sq_norms_plain(xt).numpy(), want_norms)
        idx, mask = ops.column_topk(xt, keep)  # the wrapper on the CPU: the plain version
        assert idx.dtype == torch.int32 and mask.dtype == torch.uint8
        assert np.array_equal(idx.numpy(), want_idx)
        assert np.array_equal(mask.numpy(), want_mask)


def test_plain_matches_reference_with_nan_and_inf():
    """NaN sorts above +inf and ties among NaNs go to the lower index, in
    jax.lax.top_k and in the plain version alike."""
    x = _int_inputs(3, 40, seed=7, tie_cols=8)
    x[1, [5, 17, 30]] = np.nan
    x[0, [2, 9]] = np.inf
    for keep in (1, 2, 3, 4, 5, 6, 20, 40):
        _, want_idx, want_mask = _ref_select(x, keep)
        idx, mask = ops.column_topk_plain(torch.from_numpy(x), keep)
        assert np.array_equal(idx.numpy(), want_idx), keep
        assert np.array_equal(mask.numpy(), want_mask), keep


@pytest.mark.parametrize("C", [1, 7, 8, 9, 2048, 2880])
def test_pack_mask_is_np_packbits(C):
    rng = np.random.default_rng(C)
    idx = np.sort(rng.permutation(C)[: max(1, C // 3)]).astype(np.int32)
    mask = np.zeros(C, dtype=bool)
    mask[idx] = True
    assert np.array_equal(ops.pack_mask(torch.from_numpy(idx), C).numpy(), np.packbits(mask))


def test_wire_mask_is_the_kept_columns():
    """compress_tensor's payload starts with the mask of the kept columns
    the plain version picks, in both formats."""
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 5, 100)).astype(np.float32))
    idx, mask = ops.column_topk_plain(x[0], ops.keep_count(100, 0.3))
    for qbits in (0, 8):
        payload, _, _ = compress_tensor(x, 0.3, "float32", qbits, 16)
        assert payload[: len(mask)] == mask.numpy().tobytes()


def test_column_topk_rejects_bad_keep():
    x = torch.zeros(2, 16)
    for keep in (0, 17):
        with pytest.raises(ValueError):
            ops.column_topk(x, keep)


# ---- the kernel's walk, emulated --------------------------------------------


def emulate_norms(x: np.ndarray, elem_bytes: int) -> np.ndarray:
    """The kernel's norms, bit for bit: x [R, C] holds the input's values
    as f32 (bf16 inputs widen exactly)."""
    R, C = x.shape
    n_split, rows = ops.norms_split(R, C, elem_bytes)
    sq = x * x  # f32: one rounding, as __fmul_rn
    partial = np.zeros((n_split, C), np.float32)
    for s in range(n_split):
        r0, r1 = s * rows, min(R, (s + 1) * rows)
        block = np.zeros(C, np.float32)
        for w in range(WARPS):
            acc = np.zeros(C, np.float32)
            for r in range(r0 + w, r1, WARPS):
                acc = acc + sq[r]
            block = block + acc
        partial[s] = block
    if n_split == 1:
        return partial[0]
    out = np.zeros(C, np.float32)
    for s in range(n_split):
        out = out + partial[s]
    return out


def emulate_select(norms: np.ndarray, keep: int):
    """The kernel's selection over its norms: (idx int32 [keep], mask)."""
    C = norms.shape[0]
    keys = np.where(np.isnan(norms), np.uint32(0x7FFFFFFF), norms.view(np.uint32)).astype(np.uint64)
    prefix, pmask, k = 0, 0, keep
    for shift in (24, 16, 8, 0):
        cand = keys[(keys & pmask) == prefix]
        hist = np.bincount(((cand >> shift) & 255).astype(np.int64), minlength=256)
        cnt = hist[::-1]  # thread t holds digit 255 - t
        above = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        (t,) = np.nonzero((above < k) & (above + cnt >= k))
        assert t.shape == (1,)
        t = int(t[0])
        prefix |= (255 - t) << shift
        k -= int(above[t])
        pmask |= 255 << shift
    run = (-(-C // NTHREADS) + 7) & ~7
    n_gt = np.zeros(NTHREADS, np.int64)
    n_eq = np.zeros(NTHREADS, np.int64)
    for t in range(NTHREADS):
        a, b = min(C, t * run), min(C, t * run + run)
        n_gt[t] = int((keys[a:b] > prefix).sum())
        n_eq[t] = int((keys[a:b] == prefix).sum())
    eq_before = np.concatenate([[0], np.cumsum(n_eq)[:-1]])
    mine = n_gt + np.clip(k - eq_before, 0, n_eq)
    pos = np.concatenate([[0], np.cumsum(mine)[:-1]])
    idx = np.full(keep, -1, np.int32)
    mask = np.zeros(-(-C // 8), np.uint8)
    for t in range(NTHREADS):
        a, b = min(C, t * run), min(C, t * run + run)
        eq_seen, p = int(eq_before[t]), int(pos[t])
        for i in range(a, b):
            u = keys[i]
            if u > prefix or (u == prefix and eq_seen < k):
                idx[p] = i
                p += 1
                mask[i >> 3] |= 0x80 >> (i & 7)
            if u == prefix:
                eq_seen += 1
    assert int(mine.sum()) == keep
    return idx, mask


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(1, 2048), (7, 2880), (300, 2048), (1500, 256), (40, 8192), (3, 1)])
@pytest.mark.parametrize("keep_of", ["1", "half", "all"])
def test_kernel_walk_matches_topk_columns(dtype, R, C, keep_of):
    keep = {"1": 1, "half": max(1, C // 2), "all": C}[keep_of]
    rng = np.random.default_rng(R * 7 + C)
    xt = torch.from_numpy((rng.normal(size=(R, C)) * 3).astype(np.float32)).to(dtype)
    x = xt.float().numpy()
    norms = emulate_norms(x, xt.element_size())
    assert _rel(norms, ops.column_sq_norms_plain(xt).numpy()) <= 2e-5
    idx, mask = emulate_select(norms, keep)
    want = ops.topk_columns(torch.from_numpy(norms), keep)
    assert np.array_equal(idx, want.numpy())
    assert np.array_equal(mask, ops.pack_mask(want, C).numpy())


@pytest.mark.parametrize("C", [64, 2048, 2880])
def test_kernel_walk_ties_and_nan(C):
    """Exact ties (copied and all-zero columns), +inf and NaN columns: the
    radix select's threshold and the compaction's tie rule give
    topk_columns' columns at every keep."""
    x = _int_inputs(5, C, seed=C, tie_cols=C // 2)
    x[2, C // 3] = np.nan
    x[4, C // 5] = np.nan
    x[0, C // 7] = np.inf
    norms = emulate_norms(x, 4)
    for keep in sorted({1, 2, 3, 4, C // 8 or 1, C // 2, C - 1 or 1, C}):
        idx, mask = emulate_select(norms, keep)
        want = ops.topk_columns(torch.from_numpy(norms), keep)
        assert np.array_equal(idx, want.numpy()), keep
        assert np.array_equal(mask, ops.pack_mask(want, C).numpy()), keep


@pytest.mark.parametrize("R,C,elem", [(1, 2048, 2), (1500, 2048, 2), (1500, 2048, 4), (7, 2880, 2),
                                      (1, 8192, 4), (100000, 16, 2)])
def test_norms_split_fills_the_card(R, C, elem):
    """Every row in exactly one split, splits no shorter than
    MIN_ROWS_PER_SPLIT rows (but for R below it), about TARGET_BLOCKS
    blocks at most, within the grid's y limit."""
    n_split, rows = ops.norms_split(R, C, elem)
    strips = -(-C // ops.norms_strip(elem))
    assert (n_split - 1) * rows < R <= n_split * rows
    assert rows >= min(R, ops.MIN_ROWS_PER_SPLIT) or n_split == 1
    assert n_split <= ops.MAX_GRID_Y
    assert strips * n_split <= max(ops.TARGET_BLOCKS + strips, strips)
    if (R, C, elem) == (1500, 2048, 2):
        assert (strips, n_split, rows) == (8, 33, 46)
