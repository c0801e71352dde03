"""The redesigned prefill kernel's layout and tile walk, and the dequant +
scatter kernel's strip map, in plain PyTorch, on the CPU.

The bf16 prefill kernel (csrc/flash_prefill.cu, `flash_prefill_tc_kernel`)
stacks the G query heads that share a KV head into a tile's rows (packed row
r = t * G + g), gives each block a tile of packed rows of one (batch, KV
head) (`prefill_plan`: 128 at (64, 64) for calls large enough, else 64),
runs the latest row tiles first, and lets each of its 4 warps fold a quarter
of the tile over 64-key tiles: scores on the tensor cores from q and k as
stored, the row max on the raw scores and the scale applied to the f32
scores inside exp2 (in log2 units), masks only on the tiles that cross a
row's causal limit, keys at and past the block's last attended slot
zero-filled, P rounded to bf16 for the P V product.  `prefill_tc_emulate` below is that walk written out.  In f32 (no
rounding of P) it is held to the reference's Pallas kernel in interpret mode
(`DNET_FLASH_INTERPRET=1`) within 2e-5 (tests/test_flash_decode.py:41); with
bf16 inputs and P rounded to bf16 it is held to `flash_prefill_plain` in f32
within 2e-2, the bf16 tolerance the kernel is held to on the card
(chip_smoke.py `TOL`).

The dequant + scatter kernel (csrc/column_ops.cu) maps each strip's kept
columns from the slice of the sorted `idx` that can reach it, and writes 16
bytes a thread a row where D allows (element stores otherwise);
`scatter_emulate` is that walk, held bit for bit to
`dequant_scatter_columns_plain`.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu_torch.compression.ops import (
    NTHREADS,
    dequant_scatter_columns_plain,
    quantize_q8,
    scatter_grid,
)
from dnet_tpu_torch.ops.flash_attention import (
    BK,
    NEG_INF,
    TC_ROWS,
    TC_WIDE_BLOCKS,
    TC_WIDE_ROWS,
    flash_prefill_plain,
    prefill_plan,
)

pytestmark = pytest.mark.core

TOL_F32 = dict(atol=2e-5, rtol=2e-5)
TOL_BF16 = 2e-2
LOG2E = 1.4426950408889634
WARPS = 4  # a block's warps, each owning a quarter of its packed rows
# DeepSeek-V2-Lite's softmax scale: 192^-0.5 x YaRN's mscale(40, 0.707)^2
MLA_SCALE = 192**-0.5 * (0.1 * 0.707 * np.log(40) + 1.0) ** 2
WIDTHS = [(64, 64), (128, 128), (192, 128)]


# ---- prefill_plan -------------------------------------------------------------


@pytest.mark.parametrize("G", [1, 4, 8])
def test_prefill_plan_covers_every_tile_once_heaviest_first(G):
    """For every T in 1..2048 (at G = 8 both tile sizes): each (row tile, KV
    head, batch row) is one block, every (query row, head) lies in exactly
    one tile's packed rows, and the blocks run in order of the keys their
    tile attends, most first."""
    KVH, B = 2, 2
    sizes = set()
    for T in range(1, 2049):
        plan = prefill_plan(T, KVH * G, KVH, 64, 64, B)
        sizes.add(plan.block_rows)
        order = list(plan.launch_order())
        assert len(order) == plan.blocks == len(set(order))
        assert set(order) == {(t, h, b) for t in range(plan.row_tiles) for h in range(KVH) for b in range(B)}
        ends = [plan.key_end(0, tile) for tile, _, _ in order]
        assert ends == sorted(ends, reverse=True)
        assert ends[0] == T  # the first block holds the chunk's last row
        rows = [r for tile in range(plan.row_tiles) for r in plan.tile_rows(tile)]
        assert rows == list(range(T * G))
        assert all(len(plan.tile_rows(tile)) == plan.block_rows for tile in range(plan.row_tiles - 1))
        if T <= 130 or T % 97 == 0 or T == 2048:  # the head map at every small T and a spread of large ones
            heads = {plan.head_row(kvh, r) for kvh in range(KVH) for r in rows}
            assert heads == {(t, h) for t in range(T) for h in range(KVH * G)}
    assert sizes == ({TC_ROWS, TC_WIDE_ROWS} if G == 8 else {TC_ROWS})


@pytest.mark.parametrize("T,H,KVH,dqk,dv,B", [(16, 32, 8, 64, 64, 1), (512, 32, 8, 64, 64, 1), (1024, 32, 8, 64, 64, 1),
                                             (1056, 32, 8, 64, 64, 1), (2048, 32, 8, 64, 64, 1), (256, 32, 8, 64, 64, 8),
                                             (2048, 32, 8, 128, 128, 1), (2048, 16, 16, 192, 128, 1), (600, 64, 8, 64, 64, 1)])
def test_prefill_plan_picks_128_row_tiles_only_where_they_fill_the_card(T, H, KVH, dqk, dv, B):
    """128-row tiles at (64, 64) exactly when they still make
    TC_WIDE_BLOCKS blocks (two per SM of a 132-SM card): Llama-3.2-1B's
    2048-token bucket, not its 512-token one; never at the wider pairs."""
    plan = prefill_plan(T, H, KVH, dqk, dv, B)
    wide = (dqk, dv) == (64, 64) and -(-T * (H // KVH) // TC_WIDE_ROWS) * KVH * B >= TC_WIDE_BLOCKS
    assert plan.block_rows == (TC_WIDE_ROWS if wide else TC_ROWS)
    assert plan.blocks >= TC_WIDE_BLOCKS or plan.block_rows == TC_ROWS


def test_prefill_plan_refuses_ungrouped_heads():
    with pytest.raises(ValueError):
        prefill_plan(16, 6, 4, 64, 64)


# ---- the bf16 kernel's tile walk -----------------------------------------------


def prefill_tc_emulate(q, k, v, pos, scale=None, sinks=None, round_p=None, block_rows=None):
    """csrc/flash_prefill.cu's `flash_prefill_tc_kernel`, block by block and
    warp by warp, in f32 torch: the plan's packed rows, each warp's key-tile
    bound and unmasked tiles, keys at and past the block's last attended slot
    read as zeros, the row max on the raw f32 scores, p = exp2(s * scale *
    log2(e) - m * scale * log2(e)), P rounded to bf16 for P V when round_p
    (default: bf16 inputs), l from the unrounded p, the sink folded in at
    emit in log2 units."""
    B, T, H, D = q.shape
    S, KVH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = D**-0.5 if scale is None else float(scale)
    round_p = q.dtype == torch.bfloat16 if round_p is None else round_p
    plan = prefill_plan(T, H, KVH, D, Dv, B)
    if block_rows is not None:  # a tile size the plan picks only for larger calls
        plan = replace(plan, block_rows=block_rows)
    warp_rows = plan.block_rows // WARPS
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    out = torch.empty((B, T, H, Dv), dtype=q.dtype)
    qf, kf, vf = q.float(), k.float(), v.float()
    for tile, kvh, b in plan.launch_order():
        rows = plan.tile_rows(tile)
        key_end = plan.key_end(pos, tile)
        assert key_end <= S
        for w0 in range(rows.start, rows.stop, warp_rows):
            wrows = range(w0, min(w0 + warp_rows, rows.stop))
            th = [plan.head_row(kvh, r) for r in wrows]
            t_first, t_last = th[0][0], th[-1][0]
            warp_tiles = (pos + t_last) // BK + 1
            warp_full = (pos + t_first + 1) // BK
            qw = torch.stack([qf[b, t, h] for t, h in th])
            q_lim = torch.tensor([pos + t for t, _ in th])[:, None]
            m = torch.full((len(th), 1), NEG_INF, dtype=torch.float32)
            l = torch.zeros((len(th), 1), dtype=torch.float32)
            acc = torch.zeros((len(th), Dv), dtype=torch.float32)
            for kt in range(warp_tiles):
                keys = torch.arange(kt * BK, (kt + 1) * BK)
                live = (keys < key_end)[:, None]
                kt_ = torch.where(live, kf[b, keys.clamp(max=S - 1), kvh], 0.0)
                vt_ = torch.where(live, vf[b, keys.clamp(max=S - 1), kvh], 0.0)
                x = qw @ kt_.T
                if kt >= warp_full:
                    x = torch.where(keys[None, :] > q_lim, NEG_INF, x)
                m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
                corr = torch.exp2((m - m_new) * sl2)
                p = torch.exp2(x * sl2 - m_new * sl2)
                l = l * corr + p.sum(dim=-1, keepdim=True)
                pv = p.to(torch.bfloat16).float() if round_p else p
                acc = acc * corr + pv @ vt_
                m = m_new
            for i, (t, h) in enumerate(th):
                sink = NEG_INF if sinks is None else float(sinks[h]) * LOG2E
                sink = torch.tensor(sink, dtype=torch.float32)
                m2 = m[i, 0] * sl2
                m_fin = torch.maximum(m2, sink)
                c = torch.exp2(m2 - m_fin)
                inv = c / torch.clamp(l[i, 0] * c + torch.exp2(sink - m_fin), min=1e-30)
                out[b, t, h] = (acc[i] * inv).to(q.dtype)
    return out


@pytest.fixture
def _interpret(monkeypatch):
    # the reference's REAL kernel via the pallas interpreter on CPU
    monkeypatch.setenv("DNET_FLASH_INTERPRET", "1")


def _inputs(rng, B, T, H, KVH, dqk, dv, S, sinks):
    q = rng.normal(size=(B, T, H, dqk)).astype(np.float32)
    k = rng.normal(size=(B, S, KVH, dqk)).astype(np.float32)
    v = rng.normal(size=(B, S, KVH, dv)).astype(np.float32)
    sk = rng.normal(size=(H,)).astype(np.float32) if sinks else None
    return q, k, v, sk


# (B, T, pos, S, sinks): T off the 64-row tile (and, stacked, off the packed
# grid), pos off the 64-key grid, a chunk ending at the cache's last slot,
# two batch rows; T and S multiples of 8, as the reference's tiling gate wants
PREFILL_CASES = [(1, 24, 37, 64, True), (2, 72, 0, 128, False), (1, 40, 88, 128, True)]


@pytest.mark.usefixtures("_interpret")
@pytest.mark.parametrize("dqk,dv", WIDTHS)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("B,T,pos,S,sinks", PREFILL_CASES)
def test_tile_walk_f32_matches_reference_kernel(rng, dqk, dv, G, B, T, pos, S, sinks):
    from dnet_tpu.ops.flash_attention import flash_attend_causal as ref_flash
    from dnet_tpu.ops.flash_attention import flash_eligible

    KVH = 2 if G < 8 else 1
    q, k, v, sk = _inputs(rng, B, T, KVH * G, KVH, dqk, dv, S, sinks)
    scale = MLA_SCALE if dqk == 192 else None
    assert flash_eligible(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, scale=scale,
                     sinks=None if sk is None else jnp.asarray(sk))
    got = prefill_tc_emulate(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos, scale=scale,
                             sinks=None if sk is None else torch.from_numpy(sk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_F32)


@pytest.mark.parametrize("dqk,dv", WIDTHS)
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("B,T,pos,S,sinks", PREFILL_CASES + [(1, 130, 3, 133, True)])
def test_tile_walk_bf16_matches_plain(rng, dqk, dv, G, B, T, pos, S, sinks):
    """bf16 inputs, P rounded to bf16 for P V: within the bf16 tolerance of
    the plain version computed in f32 from the same bf16 inputs (T = 130
    spans three row tiles at G = 1 and S = 133 ends on no grid)."""
    KVH = 2 if G < 8 else 1
    q, k, v, sk = (None if a is None else torch.from_numpy(a) for a in _inputs(rng, B, T, KVH * G, KVH, dqk, dv, S, sinks))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    scale = MLA_SCALE if dqk == 192 else None
    got = prefill_tc_emulate(q, k, v, pos, scale=scale, sinks=sk)
    want = flash_prefill_plain(q.float(), k.float(), v.float(), pos, scale=scale, sinks=sk)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() <= TOL_BF16


@pytest.mark.usefixtures("_interpret")
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("B,T,pos,S,sinks", PREFILL_CASES)
def test_wide_tile_walk_f32_matches_reference_kernel(rng, G, B, T, pos, S, sinks):
    """The 128-row tiles the plan picks at (64, 64) for large calls (two
    16-row m-atoms a warp), forced on small ones, against the Pallas kernel."""
    from dnet_tpu.ops.flash_attention import flash_attend_causal as ref_flash

    KVH = 2 if G < 8 else 1
    q, k, v, sk = _inputs(rng, B, T, KVH * G, KVH, 64, 64, S, sinks)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
                     sinks=None if sk is None else jnp.asarray(sk))
    got = prefill_tc_emulate(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos,
                             sinks=None if sk is None else torch.from_numpy(sk), block_rows=TC_WIDE_ROWS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_F32)


@pytest.mark.parametrize("G", [1, 4, 8])
def test_wide_tile_walk_bf16_matches_plain(rng, G):
    KVH = 2 if G < 8 else 1
    q, k, v, sk = (torch.from_numpy(a) for a in _inputs(rng, 2, 130, KVH * G, KVH, 64, 64, 200, True))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = prefill_tc_emulate(q, k, v, 70, sinks=sk, block_rows=TC_WIDE_ROWS)
    want = flash_prefill_plain(q.float(), k.float(), v.float(), 70, sinks=sk)
    assert (got.float() - want).abs().max().item() <= TOL_BF16


def test_tile_walk_reads_no_dead_slot(rng):
    """Slots at and past pos + T hold NaN: the walk never reads them (they
    are zero-filled), so the output is finite and equal to the walk over a
    cache that ends at pos + T."""
    T, pos, S = 40, 21, 128
    q, k, v, sk = (torch.from_numpy(a) for a in _inputs(rng, 1, T, 8, 2, 64, 64, S, True))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    want = prefill_tc_emulate(q, k[:, : pos + T], v[:, : pos + T], pos, sinks=sk)
    k[:, pos + T:] = float("nan")
    v[:, pos + T:] = float("nan")
    got = prefill_tc_emulate(q, k, v, pos, sinks=sk)
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, want)


# ---- the dequant + scatter kernel's strip map -----------------------------------


def scatter_emulate(src, idx, D, out_dtype=None, scale=None, bias=None, gs=0):
    """csrc/column_ops.cu's `dequant_scatter_kernel`, strip by strip and
    thread by thread: the strip's kept columns mapped from the slice
    [c0 - (D - K), c0 + W) of idx only; each thread's VEC columns written
    for every row, as one 16-byte store when D % VEC == 0, element by element
    (bounded by D) otherwise; the (row, group) scales and biases of the
    thread's first kept column's group g0 and of g0 + 1 read once a row, a
    column in a later group reading its own.  Returns (out, most scale reads
    a thread made for one row)."""
    R, K = src.shape
    out_dtype = src.dtype if out_dtype is None else out_dtype
    W, strips, _ = scatter_grid(R, D, out_dtype)
    VEC = W // NTHREADS
    idx_l = idx.tolist()
    out = torch.full((R, D), float("nan")).to(out_dtype)  # every element must be written
    most_reads = 0
    for s in range(strips):
        c0 = s * W
        kept_at = [-1] * W
        for j in range(max(0, c0 - (D - K)), min(K, c0 + W)):
            if 0 <= idx_l[j] - c0 < W:
                kept_at[idx_l[j] - c0] = j
        assert kept_at.count(-1) == W - sum(1 for c in idx_l if c0 <= c < c0 + W)  # no kept column missed
        for tid in range(NTHREADS):
            c = c0 + tid * VEC
            if c >= D:
                break
            jv = kept_at[tid * VEC : (tid + 1) * VEC]
            # the groups g0 and g0 + 1 are read once a row; a later one per column
            kept_j = [j for j in jv if j >= 0]
            g0 = kept_j[0] // gs if gs and kept_j else 0
            gsel = [j // gs - g0 if gs and j >= 0 else 0 for j in jv]
            reads = (1 if kept_j and gs else 0) + (1 in gsel) + sum(1 for g in gsel if g > 1)
            cols = []
            for j, sel in zip(jv, gsel):
                if j < 0:
                    cols.append(torch.zeros(R, dtype=out_dtype))
                elif src.dtype != torch.uint8:
                    cols.append(src[:, j])
                else:
                    sc, bi = (scale[0], bias[0]) if gs == 0 else (scale[:, g0 + sel], bias[:, g0 + sel])
                    cols.append((src[:, j].float() * sc + bi).to(out_dtype))
            most_reads = max(most_reads, reads)
            block = torch.stack(cols, dim=1)
            if D % VEC == 0:
                out[:, c : c + VEC] = block
            else:
                for e in range(VEC):
                    if c + e < D:
                        out[:, c + e] = block[:, e]
    return out, most_reads


def _idx(D, K, lo, hi, seed):
    cols = torch.randperm(hi - lo, generator=torch.Generator().manual_seed(seed))[:K] + lo
    return cols.sort().values.to(torch.int32)


# (D, K, gs, lo, hi): kept columns only in [lo, hi) (strips outside it
# empty), every column kept, odd D (rows not 16-byte aligned), one kept
# column at the very end, the hop's 2048 / 1024 / 64, and groups narrower
# than a thread's columns (4; 3, which the kernel divides by, not shifts)
SCATTER_CASES = [(4099, 300, 64, 1100, 1900), (2048, 2048, 64, 0, 2048), (1001, 1, 0, 1000, 1001),
                 (2051, 1000, 16, 0, 2051), (2048, 1024, 64, 0, 2048), (2048, 1500, 4, 0, 2048),
                 (2051, 700, 3, 0, 2051)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 7])
@pytest.mark.parametrize("D,K,gs,lo,hi", SCATTER_CASES)
def test_scatter_walk_is_bit_exact(rng, dtype, R, D, K, gs, lo, hi):
    kept = torch.from_numpy(rng.normal(size=(R, K)).astype(np.float32) * 3).to(dtype)
    idx = _idx(D, K, lo, hi, D + K)
    codes, scale, bias = quantize_q8(kept, gs)
    got, reads = scatter_emulate(codes, idx, D, dtype, scale, bias, gs)
    assert torch.equal(got, dequant_scatter_columns_plain(codes, idx, D, dtype, scale, bias, gs))
    VEC = scatter_grid(R, D, dtype)[0] // NTHREADS
    # a thread reads its first two groups' (row, group) pairs once a row, and
    # touches no third unless groups are narrower than its columns
    if gs == 0:
        assert reads == 0
    elif gs >= VEC - 1:
        assert reads <= 2
    got, _ = scatter_emulate(kept, idx, D)
    assert torch.equal(got, dequant_scatter_columns_plain(kept, idx, D))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_grid_fills_the_card_at_a_prompt_hop(dtype):
    """R = 1500 at the hop's D = 2048 runs about 4 blocks an SM of a 132-SM
    card; R = 1 runs one row a block in every strip."""
    strip, strips, rows_per_block = scatter_grid(1500, 2048, dtype)
    assert strip == NTHREADS * 16 // torch.tensor([], dtype=dtype).element_size()
    assert 400 <= strips * -(-1500 // rows_per_block) <= 4 * 132
    assert scatter_grid(1, 2048, dtype)[2] == 1
