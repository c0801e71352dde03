"""The hop codec's column ops and wire formats against dnet_tpu's.

The plain versions of the port's column kernels (compression/ops.py) are
held against dnet_tpu's TPU kernels run by the Pallas interpreter on the
CPU (`_norms_kernel`, and `_matmul_kernel` against a one-hot matrix), and
against dnet_tpu's public ops at the shapes its kernels do not tile.  The
two packages' wire formats must interoperate in both directions: sparse_v1
payloads byte for byte, qsparse8_v1 with equal column masks, codes within
1 and decoded values within one quantization step (dnet_tpu notes that its
scales may differ by an ulp between encode paths).

Tolerances: column norms within 2e-5 relative in f32 (sums of squares in
another order); gathers and scatters are copies, equal bit for bit.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dnet_tpu.compression import ops as ref_ops
from dnet_tpu.compression import wire as ref_wire
from dnet_tpu_torch.compression import ops, wire

pytestmark = pytest.mark.core

DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


def _pallas_norms(x):
    """dnet_tpu's _norms_kernel over exact row tiles, interpreted."""
    R, C = x.shape
    row_tile = R if R <= 256 else 256
    return pl.pallas_call(
        ref_ops._norms_kernel,
        grid=(R // row_tile,),
        in_specs=[pl.BlockSpec((row_tile, C), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((1, C), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, C), jnp.float32),
        interpret=True,
    )(x)[0]


def _pallas_matmul(a, b):
    """dnet_tpu's _matmul_kernel with _pallas_matmul's tiling, interpreted."""
    R, D = a.shape
    K = b.shape[1]
    tr = ref_ops._tile(R, (256, 128, 64, 32, 16, 8))
    td = ref_ops._tile(D, (512, 256, 128))
    tk = ref_ops._tile(K, (256, 128))
    assert tr and td and tk
    return pl.pallas_call(
        ref_ops._matmul_kernel,
        grid=(R // tr, K // tk, D // td),
        in_specs=[pl.BlockSpec((tr, td), lambda i, k, d: (i, d)),
                  pl.BlockSpec((td, tk), lambda i, k, d: (d, k))],
        out_specs=pl.BlockSpec((tr, tk), lambda i, k, d: (i, k)),
        out_shape=jax.ShapeDtypeStruct((R, K), jnp.float32),
        interpret=True,
    )(a, b)


def _inputs(R, C, dtype, seed=0):
    """(torch tensor, jax array) holding the same values of `dtype`."""
    np_dt, t_dt, j_dt = DTYPES[dtype]
    x = (np.random.default_rng(seed + R * 1000 + C).normal(size=(R, C)) * 3).astype(np.float32)
    x = x.astype(np_dt).astype(np.float32)  # round once, identically for both
    return torch.from_numpy(x).to(t_dt), jnp.asarray(x).astype(j_dt)


def _kept(C, K, seed=1):
    return np.sort(np.random.default_rng(seed).permutation(C)[:K]).astype(np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,C", [(8, 128), (8, 256), (256, 128), (512, 256)])
def test_norms_plain_matches_pallas_kernel(dtype, R, C):
    xt, xj = _inputs(R, C, dtype)  # exact row tiles: the TPU kernel's only shapes
    want = np.asarray(_pallas_norms(xj))
    assert _rel(ops.column_sq_norms_plain(xt).numpy(), want) <= 2e-5
    assert _rel(ops.column_sq_norms(xt).numpy(), want) <= 2e-5  # the wrapper on the CPU


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", [1, 7, 8, 300])
@pytest.mark.parametrize("C", [100, 128, 256])
def test_norms_plain_matches_public_op(dtype, R, C):
    xt, xj = _inputs(R, C, dtype)
    want = np.asarray(ref_ops.column_l2_norms(xj))
    assert _rel(ops.column_l2_norms(xt).numpy(), want) <= 2e-5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", [8, 512])
@pytest.mark.parametrize("C", [128, 256])
def test_gather_and_scatter_plain_match_pallas_one_hot_matmul(dtype, R, C):
    K = 128
    xt, xj = _inputs(R, C, dtype)
    idx = _kept(C, K)
    onehot = (np.arange(C)[:, None] == idx[None, :]).astype(np.float32)
    want = np.asarray(_pallas_matmul(xj, jnp.asarray(onehot)).astype(xj.dtype)).astype(np.float32)
    got = ops.gather_columns_plain(xt, torch.from_numpy(idx))
    assert np.array_equal(got.float().numpy(), want)
    kept_t, kept_j = got, jnp.asarray(want).astype(xj.dtype)
    want_s = np.asarray(_pallas_matmul(kept_j, jnp.asarray(onehot.T)).astype(xj.dtype)).astype(np.float32)
    got_s = ops.dequant_scatter_columns_plain(kept_t, torch.from_numpy(idx), C)
    assert got_s.dtype == xt.dtype and np.array_equal(got_s.float().numpy(), want_s)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", [1, 7, 8, 300])
@pytest.mark.parametrize("C", [100, 128, 256])
def test_gather_and_scatter_match_public_ops(dtype, R, C):
    K = max(C // 2, 1)
    xt, xj = _inputs(R, C, dtype)
    idx = _kept(C, K, seed=C)
    it = torch.from_numpy(idx)
    want = np.asarray(ref_ops.gather_columns(xj, jnp.asarray(idx))).astype(np.float32)
    got = ops.gather_columns(xt, it)
    assert np.array_equal(got.float().numpy(), want)
    want_s = np.asarray(ref_ops.scatter_columns(jnp.asarray(want).astype(xj.dtype), jnp.asarray(idx), C))
    got_s = ops.scatter_columns(got, it, C)
    assert np.array_equal(got_s.float().numpy(), want_s.astype(np.float32))


@pytest.mark.parametrize("gs", [0, 16, 64])
def test_dequant_scatter_plain_is_the_reference_dequant(gs):
    """The fused dequant + scatter against dnet_tpu's host decode of the
    same codes, scales and biases (one f32 multiply and add, each rounded)."""
    R, D, K = 9, 300, 77
    kept = torch.from_numpy(np.random.default_rng(3).normal(size=(R, K)).astype(np.float32))
    idx = torch.from_numpy(_kept(D, K))
    codes, scale, bias = ops.quantize_q8(kept, gs)
    got = ops.dequant_scatter_columns(codes, idx, D, torch.float32, scale, bias, gs)
    mask = np.zeros(D, bool)
    mask[idx.numpy()] = True
    payload = (np.packbits(mask).tobytes() + codes.numpy().tobytes() + scale.numpy().tobytes()
               + bias.numpy().tobytes())
    dtype = f"float32|fmt=qsparse8_v1|pct=0.5|orig={D}|gs={gs}"
    want = ref_wire.decompress_tensor(payload, dtype, (R, D))
    assert np.array_equal(got.numpy(), want)


def _separated(R, C, seed=0):
    """[R, C] f32 whose column norms are at least 1% apart (no near-ties at
    the k-th place, so both packages keep the same columns)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, C))
    x /= np.linalg.norm(x, axis=0, keepdims=True)
    return (x * (1.0 + 0.01 * rng.permutation(C))).astype(np.float32)


def _mask(payload: bytes, C: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(payload[: (C + 7) // 8], np.uint8), count=C).astype(bool)


@pytest.mark.parametrize("shape", [(1, 1, 256), (1, 13, 256), (2, 5, 100)])
@pytest.mark.parametrize("wire_dtype", ["float32", "bfloat16"])
def test_sparse_v1_payloads_are_byte_identical(shape, wire_dtype):
    x = _separated(int(np.prod(shape[:-1])), shape[-1]).reshape(shape)
    p_port, d_port, s_port = wire.compress_tensor(torch.from_numpy(x), 0.5, wire_dtype=wire_dtype)
    p_ref, d_ref, s_ref = ref_wire.compress_tensor(jnp.asarray(x), 0.5, wire_dtype=wire_dtype)
    assert (p_port, d_port, tuple(s_port)) == (p_ref, d_ref, tuple(s_ref))
    # each package decodes the other's frame to the same tensor
    mine = wire.decompress_tensor_device(p_ref, d_ref, s_ref, "cpu").float().numpy()
    theirs = np.asarray(ref_wire.decompress_tensor(p_port, d_port, s_port)).astype(np.float32)
    assert np.array_equal(mine, theirs)


@pytest.mark.parametrize("shape,drop,gs", [
    ((1, 1, 256), 0.5, 64), ((1, 24, 256), 0.5, 64), ((1, 24, 256), 0.0, 64),
    ((1, 6, 256), 0.5, 16), ((1, 3, 100), 0.5, 64),  # K = 50 < 64: the gs=0 per-tensor fallback
])
def test_qsparse8_interoperates(shape, drop, gs):
    R, C = int(np.prod(shape[:-1])), shape[-1]
    x = _separated(R, C, seed=R + C).reshape(shape)
    p_port, d_port, s_port = wire.compress_tensor(torch.from_numpy(x), drop, wire_dtype="float32",
                                                  quant_bits=8, group_size=gs)
    p_ref, d_ref, s_ref = ref_wire.compress_tensor(jnp.asarray(x), drop, wire_dtype="float32",
                                                   quant_bits=8, group_size=gs)
    assert d_port == d_ref and tuple(s_port) == tuple(s_ref) and len(p_port) == len(p_ref)
    mask = _mask(p_port, C)
    assert np.array_equal(mask, _mask(p_ref, C))
    K = int(mask.sum())
    eff = ref_wire._effective_group(K, gs)
    assert f"gs={eff}" in d_port
    m = (C + 7) // 8
    codes_port = np.frombuffer(p_port[m : m + R * K], np.uint8).astype(int)
    codes_ref = np.frombuffer(p_ref[m : m + R * K], np.uint8).astype(int)
    assert np.abs(codes_port - codes_ref).max() <= 1
    # decoded values within one quantization step, decoded either way
    n = (1 if eff == 0 else R * -(-K // eff)) * 4
    step = np.frombuffer(p_ref[m + R * K : m + R * K + n], np.float32).max()
    mine = wire.decompress_tensor_device(p_ref, d_ref, s_ref, "cpu").numpy().reshape(R, C)
    theirs = np.asarray(ref_wire.decompress_tensor(p_port, d_port, s_port)).reshape(R, C)
    own = wire.decompress_tensor(p_port, d_port, s_port).numpy().reshape(R, C)
    assert np.abs(mine - theirs).max() <= step * 1.0001
    assert np.abs(own - theirs).max() <= 1e-6 * max(np.abs(theirs).max(), 1.0)
    assert not own[:, ~mask].any()
    assert np.abs(own[:, mask] - x.reshape(R, C)[:, mask]).max() <= step * 0.5001


def test_topk_tie_order_matches_lax_top_k():
    """Integer-valued columns tie on their norms: both packages keep the
    lowest-indexed columns of a tied group."""
    rng = np.random.default_rng(5)
    base = rng.integers(1, 4, size=(4, 32)).astype(np.float32)
    x = np.repeat(base, 4, axis=1)  # every norm occurs at least 4 times
    for keep in (1, 5, 31, 64, 100):
        _, idx = jax.lax.top_k(ref_ops.column_l2_norms(jnp.asarray(x)), keep)
        want = np.sort(np.asarray(idx))
        got = ops.topk_columns(ops.column_l2_norms(torch.from_numpy(x)), keep).numpy()
        assert np.array_equal(got, want), keep
    p_port, d_port, _ = wire.compress_tensor(torch.from_numpy(x), 0.5, wire_dtype="float32")
    p_ref, d_ref, _ = ref_wire.compress_tensor(jnp.asarray(x), 0.5, wire_dtype="float32")
    assert (p_port, d_port) == (p_ref, d_ref)


def test_column_sparsify_matches_reference():
    x = _separated(16, 128)
    got, mask = ops.column_sparsify(torch.from_numpy(x), 0.25)
    want, want_mask = ref_ops.column_sparsify(jnp.asarray(x), 0.25)
    assert np.array_equal(mask.numpy(), np.asarray(want_mask))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_wrappers_check_their_arguments():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        ops.column_sq_norms(torch.zeros(8))
    with pytest.raises(ValueError):
        ops.dequant_scatter_columns(torch.zeros(4, 3, dtype=torch.uint8), torch.arange(3, dtype=torch.int32), 8)
    with pytest.raises(ValueError):  # codes with per-tensor params of the wrong shape
        ops.dequant_scatter_columns(torch.zeros(4, 3, dtype=torch.uint8), torch.arange(3, dtype=torch.int32), 8,
                                    torch.float32, torch.ones(2), torch.zeros(2), 0)
    with pytest.raises(ValueError):
        ops.dequant_scatter_columns(x, torch.arange(9, dtype=torch.int32), 8)
