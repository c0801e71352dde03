"""The paged kernel's tile walk and the gather kernel's strip walk, in plain
PyTorch, against dnet_tpu's kernels.

The CUDA paged kernel (csrc/paged_attention.cu) gives each KV head nx
blocks (`paged_plan` picks how many) and splits every slot's live tiles
over them in proportion to its tiles (`split_plan`, computed on the device
from the positions), lets each block's 8 warps fold their eighth of every
tile, each key's row read through its own page-table entry from the
block's staged slice of the table, merges the warps in each block and, in
the last of a slot's blocks to finish, the blocks' states and the step's
new row.  `paged_split_emulate` below is that walk written out: it records
every table entry and tile it touches, so the tests can hold it to each
live tile folded exactly once and no dead entry read (1 to 16 blocks a
slot, bt 8 / 16 / 64 / 128), and its output to the reference's Pallas
`_paged_kernel` in interpret mode (f32, 2e-5: sums in another order,
tests/test_paged_attention.py's tolerance).

The gather kernel (csrc/column_ops.cu `gather_kernel`) copies each strip's
span of x into a shared-memory window where it fits and picks the kept
values from there, else reads element by element; `gather_emulate` does the
same, tile by tile, and must equal dnet_tpu.compression.ops.gather_columns
bit for bit with sorted, unsorted and K = C indices, taking each path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu.compression.ops import gather_columns as ref_gather_columns
from dnet_tpu.ops.paged_attention import paged_attend as ref_paged_attend
from dnet_tpu_torch.compression.ops import gather_columns_plain
from dnet_tpu_torch.ops.flash_decode import MAX_SPLITS, NEG_INF
from dnet_tpu_torch.ops.paged_attention import paged_attend_plain, paged_plan

pytestmark = pytest.mark.core

TOL = dict(atol=2e-5, rtol=2e-5)
NWARPS = 8  # a paged kernel block's warps (csrc/paged_attention.cu)
TBL_MAX = 512  # page-table entries a block stages


def kernel_tile(row_bytes: int) -> int:
    """Keys per tile of the paged kernel whose K (or V) row takes
    `row_bytes` as the pool stores it: 32 where a 64-key tile of K and V
    would pass 32 KB (f32 at head dim 128), else 64 (`Cfg::BK`)."""
    return 32 if 64 * 2 * row_bytes > 32768 else 64


def split_plan(positions, nx: int, tile: int, cap: int):
    """The kernel's `split_plan`: ([s_b], [first block of slot b], T), slot
    b's live tiles split over s_b = max(1, ceil(tiles_b / T)) consecutive
    blocks of the nx, T = ceil(total / (nx - B)) but no fewer than
    ceil(most / MAX_SPLITS) (the most tiles with nx = B)."""
    tiles = [-(-min(int(p), cap) // tile) for p in positions]
    B, total, most = len(tiles), sum(tiles), max(tiles)
    T = max(1, -(-most // MAX_SPLITS), -(-total // (nx - B)) if nx > B else most)
    splits = [max(1, -(-n // T)) for n in tiles]
    first = [sum(splits[:b]) for b in range(B)]
    return splits, first, T


def split_tiles(live: int, n_split: int, split: int, tile: int) -> range:
    """The tiles block `split` of the `n_split` sharing a (slot, KV head)
    folds: ceil(tiles / n_split) each, the last ones empty for a short
    slot."""
    n_tiles = -(-live // tile)
    per = -(-n_tiles // n_split)
    begin = min(split * per, n_tiles)
    return range(begin, min(begin + per, n_tiles))


def block_rows(tables, b: int, live: int, bt: int, tile: int, tiles: range, reads: set):
    """The pool rows of a block's tiles (key -> tables[b, key // bt] * bt +
    key % bt), through the block's staged table slice [e0, e1) and past
    TBL_MAX entries through the table; every entry read goes into `reads`.
    None for a key past the live rows (zero-filled, its entry not read)."""
    if not tiles:
        return {}
    key0, key1 = tiles.start * tile, min(tiles.stop * tile, live)
    e0, e1 = key0 // bt, (key1 - 1) // bt + 1
    staged = {e: int(tables[b, e]) for e in range(e0, min(e1, e0 + TBL_MAX))}
    reads.update((b, e) for e in staged)
    rows = {}
    for key in range(tiles.start * tile, tiles.stop * tile):
        if key >= live:
            rows[key] = None
            continue
        e = key // bt
        if e - e0 >= TBL_MAX:
            reads.add((b, e))
        phys = staged[e] if e - e0 < TBL_MAX else int(tables[b, e])
        rows[key] = phys * bt + key % bt
    return rows


def paged_split_emulate(q, k_pool, v_pool, tables, pos, k_new, v_new, nx, scale=None, trace=None):
    """csrc/paged_attention.cu's walk in plain PyTorch (f32) over nx blocks a
    KV head: per (slot, KV head), block by block and warp by warp, then the
    warps merged per block and the blocks with the new row in the merging
    block's order (the new row first, then splits 0 .. s_b - 1).  `trace`
    collects the table entries read ('reads'), each (slot, KV head)'s folded
    tiles ('tiles') and the plan ('plan')."""
    B, _, H, D = q.shape
    _, bt, KVH, _ = k_pool.shape
    nb = tables.shape[1]
    G = H // KVH
    scale = D**-0.5 if scale is None else float(scale)
    tile = kernel_tile(D * k_pool.element_size())
    wk = tile // NWARPS
    kf = k_pool.float().reshape(-1, KVH, D)
    vf = v_pool.float().reshape(-1, KVH, D)
    trace = {} if trace is None else trace
    reads = trace.setdefault("reads", set())
    folded = trace.setdefault("tiles", {})
    splits, _, _ = trace["plan"] = split_plan(pos.tolist(), nx, tile, nb * bt)
    out = torch.empty(B, KVH, G, D)
    for b in range(B):
        live = min(int(pos[b]), nb * bt)
        n_split = splits[b]
        for h in range(KVH):
            qf = q[b, 0, h * G:(h + 1) * G].float() * scale
            states = []
            for split in range(n_split):
                tiles = split_tiles(live, n_split, split, tile)
                folded.setdefault((b, h), []).extend(tiles)
                rows = block_rows(tables, b, live, bt, tile, tiles, reads)
                warps = []
                for w in range(NWARPS):
                    m, l, a = torch.full((G,), NEG_INF), torch.zeros(G), torch.zeros(G, D)
                    for t in tiles:
                        keys = [t * tile + w * wk + i for i in range(wk)]
                        if keys[0] >= live:
                            continue
                        kt = torch.stack([kf[rows[k], h] if rows[k] is not None else torch.zeros(D) for k in keys])
                        vt = torch.stack([vf[rows[k], h] if rows[k] is not None else torch.zeros(D) for k in keys])
                        valid = torch.tensor([rows[k] is not None for k in keys])
                        s = torch.where(valid, qf @ kt.T, NEG_INF)
                        m_new = torch.maximum(m, s.amax(dim=-1))
                        p = torch.exp(s - m_new[:, None])
                        corr = torch.exp(m - m_new)
                        l = l * corr + p.sum(dim=-1)
                        a = a * corr[:, None] + p @ vt
                        m = m_new
                    warps.append((m, l, a))
                mw = torch.stack([x[0] for x in warps]).amax(dim=0)
                ws = [torch.exp(x[0] - mw) for x in warps]
                states.append((mw, sum(wt * x[1] for wt, x in zip(ws, warps)),
                               sum(wt[:, None] * x[2] for wt, x in zip(ws, warps))))
            sn = qf @ k_new[b, h].float()
            M = torch.stack([sn] + [st[0] for st in states]).amax(dim=0)
            wn = torch.exp(sn - M)
            x, ll = wn[:, None] * v_new[b, h].float()[None, :], wn
            for st in states:
                wt = torch.exp(st[0] - M)
                x = x + wt[:, None] * st[2]
                ll = ll + wt * st[1]
            out[b, h] = x / ll[:, None]
    return out.reshape(B, 1, H, D).to(q.dtype)


def _case(seed, bt, positions, H=8, KVH=2, D=64, cap=None):
    """Random pool, each slot's live blocks at shuffled physical blocks,
    every dead entry pointing at one NaN block."""
    rng = np.random.default_rng(seed)
    cap = cap or max(-(-max(positions + [1]) // bt), 1) * bt
    nb = cap // bt
    per_slot = [-(-p // bt) for p in positions]
    n_blocks = sum(per_slot) + 1
    perm = rng.permutation(n_blocks - 1)
    tables = np.full((len(positions), nb), n_blocks - 1, dtype=np.int32)
    start = 0
    for b, n in enumerate(per_slot):
        tables[b, :n] = perm[start:start + n]
        start += n
    k_pool = rng.normal(size=(n_blocks, bt, KVH, D)).astype(np.float32)
    v_pool = rng.normal(size=(n_blocks, bt, KVH, D)).astype(np.float32)
    k_pool[-1] = np.nan
    v_pool[-1] = np.nan
    B = len(positions)
    return (rng.normal(size=(B, 1, H, D)).astype(np.float32), k_pool, v_pool, tables,
            np.asarray(positions, dtype=np.int32), rng.normal(size=(B, KVH, D)).astype(np.float32),
            rng.normal(size=(B, KVH, D)).astype(np.float32))


def _walk(positions, nx, bt, nb, tile=64):
    """The table entries and tiles the kernel's walk touches (no
    arithmetic): ({(slot, entry)}, {slot: [tile, ...]}, {slot: [tiles a
    block]}, the plan)."""
    tables = np.arange(len(positions) * nb, dtype=np.int32).reshape(len(positions), nb)
    plan = split_plan(positions, nx, tile, nb * bt)
    reads, folded, sizes = set(), {}, {}
    for b, p in enumerate(positions):
        live = min(p, nb * bt)
        for split in range(plan[0][b]):
            tiles = split_tiles(live, plan[0][b], split, tile)
            folded.setdefault(b, []).extend(tiles)
            sizes.setdefault(b, []).append(len(tiles))
            block_rows(tables, b, live, bt, tile, tiles, reads)
    return reads, folded, sizes, plan


# batch_serve's ragged lanes, a slot at pos 0, block edges, a full table
WALK_POSITIONS = [0, 1, 57, 127, 128, 129, 1530, 4096]


@pytest.mark.parametrize("bt", [8, 16, 64, 128])
@pytest.mark.parametrize("per_slot", range(1, MAX_SPLITS + 1))
def test_tile_walk_folds_each_live_tile_once_and_reads_no_dead_entry(per_slot, bt):
    """With per_slot x slots blocks a KV head: every live tile of every slot
    folded exactly once, no block past T tiles, at most MAX_SPLITS blocks a
    slot and the plan within the budget, and exactly the live blocks'
    table entries read."""
    nb, B = 4096 // bt, len(WALK_POSITIONS)
    nx = per_slot * B
    reads, folded, sizes, (splits, first, T) = _walk(WALK_POSITIONS, nx, bt, nb)
    assert sum(splits) <= nx and max(splits) <= MAX_SPLITS
    assert first == [sum(splits[:b]) for b in range(B)]
    tiles = [-(-p // 64) for p in WALK_POSITIONS]
    for b, p in enumerate(WALK_POSITIONS):
        assert folded[b] == list(range(tiles[b]))
        assert max(sizes[b]) <= T
        # exactly the entries of the slot's live blocks
        assert {e for s, e in reads if s == b} == set(range(-(-p // bt)))


def test_paged_plan_balances_batch_serve_lanes():
    """batch_serve's 8 lanes x 8 KV heads at pos 59 to 1,532: two blocks an
    SM give 32 a KV head, split by the lanes' tiles (1 to 24) so that no
    block takes more than 4 (one split count for every lane would give the
    longest 6)."""
    positions = [59, 92, 182, 332, 552, 832, 1132, 1532]
    nx = paged_plan(max(positions), 8, 8, blocks_per_sm=2)
    assert nx == 32
    splits, _, T = split_plan(positions, nx, 64, 4096)
    assert T == 4 and splits == [1, 1, 1, 2, 3, 4, 5, 6]
    assert paged_plan(4096, 1, 8) == MAX_SPLITS
    assert paged_plan(0, 8, 8) == 8


@pytest.fixture(scope="module")
def ragged_reference():
    """The reference's interpret-mode kernel on ragged slots at bt 8 and 16,
    G = 4 and G = 1 (its output per case)."""
    out = {}
    for bt in (8, 16):
        for H, KVH in ((8, 2), (4, 4)):
            case = _case(bt + H, bt, [0, 5, bt, 3 * bt - 3, 140], H=H, KVH=KVH, cap=160)
            out[bt, H, KVH] = case, np.asarray(
                ref_paged_attend(*(jnp.asarray(a) for a in case), impl="interpret"))
    return out


@pytest.mark.parametrize("H,KVH", [(8, 2), (4, 4)])
@pytest.mark.parametrize("bt", [8, 16])
def test_tile_walk_matches_reference_kernel(ragged_reference, bt, H, KVH):
    """Every split count folds to the reference's output within 2e-5, the
    NaN block behind every dead entry never read; a slot at pos 0 gives
    exactly v_new."""
    case, want = ragged_reference[bt, H, KVH]
    assert np.isfinite(want).all()
    t = [torch.from_numpy(a) for a in case]
    plain = paged_attend_plain(*t)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    B = len(case[4])
    for per_slot in (1, 2, 3, 7, MAX_SPLITS):
        trace = {}
        got = paged_split_emulate(*t, nx=per_slot * B, trace=trace)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert torch.equal(got[0, 0], t[6][0].repeat_interleave(H // KVH, dim=0))
        live_entries = {(b, e) for b, p in enumerate(case[4]) for e in range(-(-int(p) // bt))}
        assert trace["reads"] == live_entries


def test_tile_walk_f32_head_dim_128_uses_32_key_tiles():
    """f32 at head dim 128: 32-key tiles (a 64-key tile would pass 32 KB);
    the walk still folds every key once, against the plain version."""
    assert kernel_tile(128 * 4) == 32 and kernel_tile(128 * 2) == 64 and kernel_tile(64 * 4) == 64
    case = _case(3, 16, [33, 100, 0], H=4, KVH=2, D=128, cap=128)
    t = [torch.from_numpy(a) for a in case]
    want = paged_attend_plain(*t)
    for per_slot in (1, 4):
        trace = {}
        got = paged_split_emulate(*t, nx=per_slot * 3, trace=trace)
        torch.testing.assert_close(got, want, **TOL)
        assert trace["tiles"][(1, 0)] == list(range(4))


# ---- the gather kernel's strip walk -------------------------------------------

GATHER_ROWS = 16
GATHER_WINDOW = 2048


def gather_emulate(x: torch.Tensor, idx: torch.Tensor, stats=None) -> torch.Tensor:
    """csrc/column_ops.cu's `gather_kernel`, strip by strip and tile by
    tile: a strip of 32 x VEC kept columns (VEC = 16 bytes of elements),
    tiles of 16 rows; a tile of two or more rows whose x rows are 16-byte
    multiples and whose strip's span [idx[j0], idx[j_last]] fits a 2 KB
    window copies the aligned span and reads from it (columns outside the
    span from x), else reads x element by element.  `stats` counts tiles by
    path ('staged', 'direct')."""
    R, C = x.shape
    K = idx.shape[0]
    esz = x.element_size()
    vec = 16 // esz
    jw = 32 * vec
    we = GATHER_WINDOW // esz
    stats = {} if stats is None else stats
    out = torch.empty(R, K, dtype=x.dtype)
    cols = [int(c) for c in idx]
    for j0 in range(0, K, jw):
        jl = min(K, j0 + jw) - 1
        lo, hi = cols[j0], cols[jl]
        lo_al, hi_end = lo & ~(vec - 1), (hi + vec) & ~(vec - 1)
        for r0 in range(0, R, GATHER_ROWS):
            rows = min(GATHER_ROWS, R - r0)
            staged = rows > 1 and C * esz % 16 == 0 and lo <= hi and hi_end - lo_al <= we
            stats[("staged" if staged else "direct")] = stats.get("staged" if staged else "direct", 0) + 1
            window = x[r0:r0 + rows, lo_al:hi_end].clone() if staged else None
            for j in range(j0, jl + 1):
                c = cols[j]
                if staged and lo <= c <= hi:
                    out[r0:r0 + rows, j] = window[:, c - lo_al]
                else:
                    out[r0:r0 + rows, j] = x[r0:r0 + rows, c]
    return out


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)).numpy()


def _ref_bits(x: torch.Tensor, idx: torch.Tensor) -> np.ndarray:
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    out = np.asarray(ref_gather_columns(xj, jnp.asarray(idx.numpy())))
    return out.view(np.int16) if x.element_size() == 2 else out.view(np.int32)


def _idx(kind, C, K, seed):
    g = torch.Generator().manual_seed(seed)
    if kind == "all":
        return torch.arange(C, dtype=torch.int32)
    pick = torch.randperm(C, generator=g)[:K]
    return (pick if kind == "unsorted" else pick.sort().values).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,C,K,kind,paths", [
    (40, 512, 256, "sorted", {"staged"}),  # the codec's: spans fit the window
    (17, 512, 300, "sorted", {"staged", "direct"}),  # a last tile of one row reads directly
    (1, 512, 256, "sorted", {"direct"}),  # a decode hop: one row, no reuse
    (20, 4096, 64, "sorted", {"direct"}),  # sparse columns: the span exceeds the window
    (20, 512, 256, "unsorted", None),  # spans of an unsorted idx: x read outside them
    (20, 512, 512, "all", None),  # K = C
    (20, 511, 200, "sorted", {"direct"}),  # x's rows are not 16-byte multiples
    (3, 304, 1, "sorted", {"staged"}),  # one kept column
])
def test_gather_strip_walk_is_bit_exact(dtype, R, C, K, kind, paths):
    x = torch.randn(R, C, generator=torch.Generator().manual_seed(R * C + K)).to(dtype)
    x[0, 0] = float("nan")
    idx = _idx(kind, C, K, R + K)
    stats = {}
    got = gather_emulate(x, idx, stats)
    assert np.array_equal(_bits(got), _ref_bits(x, idx))
    assert np.array_equal(_bits(got), _bits(gather_columns_plain(x, idx)))
    if paths is not None:
        assert set(stats) == paths
