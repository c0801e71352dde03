"""The port's ragged paged attention (its plain version, which the wrapper
takes for CPU tensors) against dnet_tpu's Pallas kernel in interpret mode,
on the same numpy inputs: ragged and mid-block positions, pos = 0, G = 1
and G = 4, bt in {8, 16}.  Tolerance 2e-5 in f32 (sums in another order);
dead table entries must not change the output by one bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dnet_tpu.ops.paged_attention import paged_attend as ref_paged_attend
from dnet_tpu.ops.paged_attention import ragged_refusal as ref_ragged_refusal
from dnet_tpu_torch.ops.paged_attention import paged_attend, paged_attend_plain, ragged_refusal

pytestmark = pytest.mark.core

NB = 4  # table width
N_BLOCKS = 16
TOL = dict(atol=2e-5, rtol=2e-5)


def _case(seed, bt=8, B=3, H=4, KVH=2, Hd=16, pos=None):
    """Random pool + shuffled per-slot tables covering pos + 1 tokens (the
    reference's own test layout, tests/test_paged_attention.py)."""
    rng = np.random.default_rng(seed)
    k_pool = rng.normal(size=(N_BLOCKS, bt, KVH, Hd)).astype(np.float32)
    v_pool = rng.normal(size=(N_BLOCKS, bt, KVH, Hd)).astype(np.float32)
    perm = rng.permutation(N_BLOCKS)[: B * NB].reshape(B, NB)
    pos = np.asarray(pos if pos is not None else [1, bt * 2, bt * 3 - 3], dtype=np.int32)
    tables = np.zeros((B, NB), dtype=np.int32)
    for b in range(B):
        nb_live = -(-int(pos[b] + 1) // bt)
        tables[b, :nb_live] = perm[b, :nb_live]
    q = rng.normal(size=(B, 1, H, Hd)).astype(np.float32)
    k_new = rng.normal(size=(B, KVH, Hd)).astype(np.float32)
    v_new = rng.normal(size=(B, KVH, Hd)).astype(np.float32)
    return q, k_pool, v_pool, tables, pos, k_new, v_new


def _both(case):
    want = np.asarray(ref_paged_attend(*(jnp.asarray(a) for a in case), impl="interpret"))
    got = paged_attend(*(torch.from_numpy(a) for a in case))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("bt", [8, 16])
@pytest.mark.parametrize(
    "seed,pos",
    [
        (1, lambda bt: [0, 5, bt * NB - 1]),  # empty slot, mid-block, last row
        (2, lambda bt: [bt - 1, bt, bt + 1]),  # either side of a block edge
        (3, lambda bt: [2 * bt - 5, 3 * bt - 1, 7]),  # stale tails in the last live block
    ],
)
def test_plain_matches_interpret_kernel_ragged(bt, seed, pos):
    got, want = _both(_case(seed, bt=bt, pos=pos(bt)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bt", [8, 16])
@pytest.mark.parametrize("H,KVH", [(2, 2), (8, 2)])
def test_gqa_group_folding(bt, H, KVH):
    """G = 1 and G = 4 fold onto the same KV rows."""
    got, want = _both(_case(6, bt=bt, H=H, KVH=KVH))
    np.testing.assert_allclose(got, want, **TOL)


def test_empty_pool_gives_the_new_row():
    """pos == 0 (nothing live, also every inactive lane): the output is
    v_new, repeated over each KV head's query group."""
    q, k_pool, v_pool, tables, _, k_new, v_new = _case(5)
    pos = np.zeros(3, dtype=np.int32)
    got, want = _both((q, k_pool, v_pool, tables, pos, k_new, v_new))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.repeat(v_new, 2, axis=1)[:, None], atol=1e-6)


@pytest.mark.parametrize("bt", [8, 16])
def test_dead_table_entries_are_never_read(bt):
    """Entries past each slot's live blocks pointed at other blocks, and at
    a NaN-filled one: the output does not change by one bit."""
    q, k_pool, v_pool, tables, pos, k_new, v_new = _case(4, bt=bt, pos=[3, 9, 12])
    args = [torch.from_numpy(a) for a in (q, k_pool, v_pool, tables, pos, k_new, v_new)]
    out1 = paged_attend(*args)
    poisoned = tables.copy()
    for b in range(poisoned.shape[0]):
        live = -(-int(pos[b]) // bt)
        poisoned[b, live:] = (poisoned[b, 0] + 1) % N_BLOCKS
    args[3] = torch.from_numpy(poisoned)
    torch.testing.assert_close(paged_attend(*args), out1, rtol=0, atol=0)
    nan_pool = k_pool.copy()
    used = {int(tables[b, i]) for b in range(3) for i in range(-(-int(pos[b]) // bt))}
    dead = next(i for i in range(N_BLOCKS) if i not in used)
    nan_pool[dead] = np.nan
    poisoned[:] = np.where(np.arange(NB)[None, :] < -(-pos[:, None] // bt), tables, dead)
    args[1], args[3] = torch.from_numpy(nan_pool), torch.from_numpy(poisoned)
    torch.testing.assert_close(paged_attend(*args), out1, rtol=0, atol=0)


def test_cpu_wrapper_takes_the_plain_version_and_launches_nothing():
    case = [torch.from_numpy(a) for a in _case(7)]
    before = paged_attend.launches
    torch.testing.assert_close(paged_attend(*case), paged_attend_plain(*case), rtol=0, atol=0)
    assert paged_attend.launches == before


def test_bf16_inputs_keep_their_dtype():
    case = [torch.from_numpy(a) for a in _case(8)]
    case = [t.bfloat16() if t.is_floating_point() else t for t in case]
    out = paged_attend(*case)
    assert out.dtype == torch.bfloat16
    want = paged_attend_plain(*(t.float() if t.is_floating_point() else t for t in case))
    assert (out.float() - want).abs().max().item() <= 2e-2


def test_shape_validation():
    q, k_pool, v_pool, tables, pos, k_new, v_new = (torch.from_numpy(a) for a in _case(9))
    with pytest.raises(ValueError, match="one query row"):
        paged_attend(q.expand(-1, 2, -1, -1), k_pool, v_pool, tables, pos, k_new, v_new)
    with pytest.raises(ValueError, match="tables"):
        paged_attend(q, k_pool, v_pool, tables[:2], pos, k_new, v_new)
    with pytest.raises(ValueError, match="new rows"):
        paged_attend(q, k_pool, v_pool, tables, pos, k_new[:, :1], v_new)
    with pytest.raises(ValueError, match="multiple"):
        paged_attend(q[:, :, :3], k_pool[..., :], v_pool, tables, pos, k_new, v_new)


def test_ragged_refusal_vocabulary_matches_the_reference():
    class FakeCfg:
        model_type = "fake"

    class Dense:
        config = FakeCfg()
        supports_paged_attend = False

    class Ok:
        config = FakeCfg()
        supports_paged_attend = True

    for model, bits in ((Dense(), 0), (Ok(), 8), (Ok(), 0)):
        assert ragged_refusal(model, bits) == ref_ragged_refusal(model, bits)
    assert "paged-attend" in ragged_refusal(Dense())
