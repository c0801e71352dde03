"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and skips without one.  The file imports neither jax
nor dnet_tpu, so it runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Shapes are Llama-3.2-1B's (H=32, KVH=8, D=64); the paged kernel reads a
block pool through shuffled page tables at ragged per-slot lengths.  The
hop codec's column kernels run at its widths (C=2048) and at odd ones, with
R=1 frames: norms within 2e-5 relative in f32 (1e-2 in bf16 inputs summed
in f32), gather and dequant-scatter equal bit for bit.  Tolerances: f32 1e-4 (sums
in another order); bf16 2e-2 against the plain version computed in f32
from the same bf16 inputs (the kernel rounds its output to bf16, ~4e-3 at
|x| ~ 1, and sums in another order).
"""

import pytest
import torch

from dnet_tpu_torch.compression.ops import (
    column_sq_norms,
    column_sq_norms_plain,
    dequant_scatter_columns,
    dequant_scatter_columns_plain,
    gather_columns,
    gather_columns_plain,
    quantize_q8,
)
from dnet_tpu_torch.ops.flash_attention import flash_prefill, flash_prefill_plain
from dnet_tpu_torch.ops.flash_decode import flash_decode_attend, flash_decode_plain
from dnet_tpu_torch.ops.paged_attention import paged_attend, paged_attend_plain

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, dtype, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,pos,S,sinks", [(100, 37, 512, False), (64, 0, 64, True), (17, 200, 300, False)])
def test_prefill_kernel_matches_plain(gen, dtype, T, pos, S, sinks):
    q = _randn(gen, dtype, 1, T, 32, 64)
    k, v = _randn(gen, dtype, 1, S, 8, 64), _randn(gen, dtype, 1, S, 8, 64)
    sk = torch.randn(32, generator=gen, device="cuda") if sinks else None
    before = flash_prefill.launches
    out = flash_prefill(q, k, v, pos, sinks=sk)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    want = flash_prefill_plain(q.float(), k.float(), v.float(), pos, sinks=sk)
    assert (out.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 63, 64, 1024, 4095])
def test_decode_kernel_matches_plain(gen, dtype, pos):
    q = _randn(gen, dtype, 1, 1, 32, 64)
    k, v = _randn(gen, dtype, 1, 4096, 8, 64), _randn(gen, dtype, 1, 4096, 8, 64)
    before = flash_decode_attend.launches
    out = flash_decode_attend(q, k, v, pos)
    torch.cuda.synchronize()
    assert flash_decode_attend.launches == before + 1
    want = flash_decode_plain(q.float(), k.float(), v.float(), pos)
    assert (out.float() - want).abs().max().item() <= TOL[dtype]


def test_cuda_tensor_never_takes_the_plain_version(gen):
    """A dtype the kernel does not take raises on the card instead of
    computing through the plain version."""
    q = _randn(gen, torch.float16, 1, 16, 32, 64)
    k = _randn(gen, torch.float16, 1, 64, 8, 64)
    with pytest.raises(ValueError):
        flash_prefill(q, k, k, 0)
    with pytest.raises(ValueError):
        flash_decode_attend(q[:, :1], k, k, 3)


PAGED_POSITIONS = [0, 15, 16, 100, 1023, 2047, 4000, 4094]


def _paged_case(gen, dtype, bt, positions=PAGED_POSITIONS, cap=4096):
    """A pool holding every slot's live blocks in shuffled order, plus one
    NaN block that every dead table entry points at: a kernel that read a
    dead entry would put NaN into its output."""
    B, KVH, D = len(positions), 8, 64
    nb = cap // bt
    per_slot = [-(-p // bt) for p in positions]  # blocks holding rows [0, pos)
    n_blocks = sum(per_slot) + 1
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(bt))
    tables = torch.full((B, nb), n_blocks - 1, dtype=torch.int32)
    start = 0
    for b, n in enumerate(per_slot):
        tables[b, :n] = perm[start : start + n].to(torch.int32)
        start += n
    k_pool = _randn(gen, dtype, n_blocks, bt, KVH, D)
    v_pool = _randn(gen, dtype, n_blocks, bt, KVH, D)
    k_pool[-1] = float("nan")
    v_pool[-1] = float("nan")
    return (
        _randn(gen, dtype, B, 1, 32, D), k_pool, v_pool, tables.cuda(),
        torch.tensor(positions, dtype=torch.int32, device="cuda"),
        _randn(gen, dtype, B, KVH, D), _randn(gen, dtype, B, KVH, D),
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt", [8, 16, 64])
def test_paged_kernel_matches_plain(gen, dtype, bt):
    """Ragged slots (pos 0, mid-block, block edges, near capacity) through
    shuffled tables with poisoned dead entries; the split is planned from
    the true bound and from one far below it (which costs balance, never
    rows)."""
    case = _paged_case(gen, dtype, bt)
    want = paged_attend_plain(*(t.float() if t.is_floating_point() else t for t in case))
    assert bool(torch.isfinite(want).all())
    for max_live in (max(PAGED_POSITIONS), None, 100):
        before = paged_attend.launches
        out = paged_attend(*case, max_live=max_live)
        torch.cuda.synchronize()
        assert paged_attend.launches == before + 1
        assert out.shape == case[0].shape and out.dtype == dtype
        assert (out.float() - want).abs().max().item() <= TOL[dtype]


def test_paged_kernel_cuda_tensor_never_takes_the_plain_version(gen):
    q, k_pool, v_pool, tables, pos, k_new, v_new = _paged_case(gen, torch.float32, 16, [3, 40])
    with pytest.raises(ValueError):
        paged_attend(q.half(), k_pool.half(), v_pool.half(), tables, pos, k_new.half(), v_new.half())
    with pytest.raises(ValueError):  # int64 tables are not the kernel's
        paged_attend(q, k_pool, v_pool, tables.long(), pos, k_new, v_new)


def _kept_idx(gen, C, K):
    """K sorted unique columns of C that always include 0 and C - 1."""
    inner = torch.randperm(C - 2, generator=torch.Generator().manual_seed(C + K))[: K - 2] + 1
    idx = torch.cat([torch.tensor([0, C - 1]), inner]).sort().values
    return idx.to(torch.int32).cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(1, 2048), (1500, 2048), (7, 100), (300, 257), (1, 1)])
def test_column_norms_kernel_matches_plain(gen, dtype, R, C):
    x = _randn(gen, dtype, R, C) * 3
    before = column_sq_norms.launches
    out = column_sq_norms(x)
    again = column_sq_norms(x)
    torch.cuda.synchronize()
    assert column_sq_norms.launches == before + 2
    assert out.shape == (C,) and out.dtype == torch.float32
    assert torch.equal(out, again)  # no float atomics: the same bits every call
    want = column_sq_norms_plain(x)
    rel = ((out - want).abs() / want.abs().clamp(min=1e-30)).max().item()
    assert rel <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C,K", [(1, 2048, 1024), (1500, 2048, 1024), (5, 101, 37), (3, 2, 2)])
def test_gather_kernel_is_bit_exact(gen, dtype, R, C, K):
    x = _randn(gen, dtype, R, C)
    idx = _kept_idx(gen, C, K)
    before = gather_columns.launches
    out = gather_columns(x, idx)
    torch.cuda.synchronize()
    assert gather_columns.launches == before + 1
    assert torch.equal(out, gather_columns_plain(x, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D,K,gs", [(1, 2048, 1024, 64), (1500, 2048, 1024, 64), (1, 2048, 1024, 0),
                                      (9, 300, 77, 16), (4, 129, 129, 0)])
def test_dequant_scatter_kernel_is_bit_exact(gen, dtype, R, D, K, gs):
    kept = _randn(gen, dtype, R, K)
    idx = _kept_idx(gen, D, K)
    codes, scale, bias = quantize_q8(kept, gs)
    before = dequant_scatter_columns.launches
    out = dequant_scatter_columns(codes, idx, D, dtype, scale, bias, gs)
    torch.cuda.synchronize()
    assert dequant_scatter_columns.launches == before + 1
    want = dequant_scatter_columns_plain(codes, idx, D, dtype, scale, bias, gs)
    assert out.dtype == dtype and torch.equal(out, want)
    # the sparse_v1 form: a plain scatter of the kept columns
    out = dequant_scatter_columns(kept, idx, D)
    assert torch.equal(out, dequant_scatter_columns_plain(kept, idx, D))
    dropped = torch.ones(D, dtype=torch.bool, device="cuda")
    dropped[idx.long()] = False
    assert not out[:, dropped].any()


def test_column_kernels_never_take_the_plain_version(gen):
    x = _randn(gen, torch.float16, 4, 64)
    idx = torch.arange(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        column_sq_norms(x)
    with pytest.raises(ValueError):  # int64 indices are not the kernel's
        gather_columns(x.float(), idx.long())
    with pytest.raises(ValueError):
        dequant_scatter_columns(x[:, :8], idx, 64)
