"""Groups wider than a kernel block's 8 query rows (G = H / KVH > 8), against
dnet_tpu's kernels, on the CPU.

The decode and paged CUDA kernels hold GP = 1, 4 or 8 query rows a block
and split a wider group over RG = ceil(G / GP) row groups of blocks in the
same launch: block x of a (lane, KV head) is split x // RG, row group
x % RG, folding query heads kvh * G + r * GP .. min(G, (r + 1) * GP) - 1;
the last group's rows past G load q as zeros and are never written, and
each (lane, KV head, row group) keeps its own merge states and ticket
(csrc/flash_decode.cu, csrc/paged_attention.cu).

- The plain versions the wrappers run on the CPU (decode: plain, q8, q4
  and LSE; paged) at G = 12 and 16 against the reference's Pallas kernels
  in interpret mode (DNET_FLASH_INTERPRET=1; the LSE partials against its
  `_decode_emulate(..., with_lse=True)`, as tests/test_torch_decode_plan.py
  holds them), f32 within 2e-5 (tests/test_flash_decode.py:41).
- `row_group_launch` / `paged_row_group_launch` below write the kernels'
  row-group grids out block by block in plain PyTorch, with the tickets, at
  the CUDA-core forms' rows and at the tensor-core forms' 16: every
  (KV head, query head) is folded and written exactly once, the masked rows
  never, every ticket counts exactly its own row group's blocks (a merge
  keyed by (lane, KV head) alone would see RG x n_split blocks and fire
  early), and the outputs match the reference's kernels (the decode grid
  through the plain version, which the tests above hold to them).
- A tiny qwen3_moe with H = 16 over KVH = 1 (G = 16) through the port's
  engine against the reference's, decode going through the G > 8 forms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu_torch.ops.flash_decode import (
    BK,
    MAX_ROWS,
    NEG_INF,
    decode_plan,
    flash_decode_attend,
    flash_decode_lse,
    query_rows,
    row_groups,
)
from dnet_tpu_torch.ops.paged_attention import paged_attend, paged_plan
from tests.test_torch_decode_plan import _codes, _inputs, _ref_lane, _ref_lse, _t, split_tiles
from tests.test_torch_paged_plan import _case, split_plan

pytestmark = pytest.mark.core

TOL = dict(atol=2e-5, rtol=2e-5)
S = 512


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DNET_FLASH_INTERPRET", "1")


def test_rows_and_row_groups():
    """The launcher's CUDA-core layout: 1, 4 or 8 rows a block, 8 past 8
    (G = 12 as 8 + 4, G = 16 as two 8s), every G > 4 at head dim 128 as
    groups of 4 (the GP = 8 instantiation spills there and is not built;
    tests/test_torch_decode_mma.py tables the tensor-core form), and the
    split plan counts every (KV head, row group): G = 16 over 4 KV heads
    plans as G = 8 over 8."""
    assert [query_rows(g, 64) for g in (1, 3, 4, 5, 8, 9, 12, 16, 32)] == [1, 4, 4, 8, 8, 8, 8, 8, 8]
    assert [row_groups(g, query_rows(g, 64)) for g in (8, 9, 12, 16, 32)] == [1, 2, 2, 2, 4]
    assert [query_rows(g, 128) for g in (5, 7, 8, 16)] == [4] * 4 and MAX_ROWS == 8
    assert decode_plan(2048, 4 * row_groups(16, 8)) == decode_plan(2048, 8)
    assert paged_plan(1532, 8, 4 * row_groups(16, 8), 1) == paged_plan(1532, 8, 8, 1)


# ---- the plain versions against the reference's kernels ------------------

@pytest.mark.parametrize("G", [12, 16])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_decode_plain_matches_reference_kernel(rng, G, bits):
    """Lanes at a tile edge, mid-tile, the last slot and an idle one."""
    q, k, v = _inputs(rng, 4, 2 * G, 2, 16, 16)
    cache = _codes(bits, k, v) if bits else {"k": k, "v": v}
    lengths = [64, 0, 301, S]
    got = flash_decode_attend(_t(q), _t(cache["k"]), _t(cache["v"]), torch.tensor(lengths, dtype=torch.int32),
                              S, k_scale=_t(cache.get("k_scale")), v_scale=_t(cache.get("v_scale"))).numpy()
    assert not got[1].any()
    for b in (0, 2, 3):
        lane = {n: a[b : b + 1] for n, a in cache.items()}
        np.testing.assert_allclose(got[b : b + 1], _ref_lane(q[b : b + 1], lane, lengths[b] - 1), **TOL)


@pytest.mark.parametrize("G", [12, 16])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_lse_plain_matches_reference_emulation(rng, G, bits):
    """One sp rank's partials at G > 8: m and l within 2e-5, acc within it
    relative to l, an empty lane exactly (0, NEG_INF, 0)."""
    H, S_local = 2 * G, 256
    q, k, v = _inputs(rng, 3, H, 2, 16, 16, S=S_local)
    cache = _codes(bits, k, v) if bits else {"k": k, "v": v}
    lengths = [200, 0, S_local]
    acc, m, l = flash_decode_lse(_t(q), _t(cache["k"]), _t(cache["v"]), torch.tensor(lengths, dtype=torch.int32),
                                 S_local, k_scale=_t(cache.get("k_scale")), v_scale=_t(cache.get("v_scale")))
    assert m.shape == (3, 2, G)
    for b, live in enumerate(lengths):
        lane = {n: a[b : b + 1] for n, a in cache.items()}
        w_acc, w_m, w_l = _ref_lse(q[b : b + 1], lane, live, None, S_local)
        np.testing.assert_allclose(m[b : b + 1].numpy(), w_m, **TOL)
        np.testing.assert_allclose(l[b : b + 1].numpy(), w_l, **TOL)
        norm = np.maximum(w_l, 1e-30).reshape(1, 1, H, 1)
        np.testing.assert_allclose(acc[b : b + 1].numpy() / norm, w_acc / norm, **TOL)
    assert (m[1] == NEG_INF).all() and (l[1] == 0).all() and (acc[1] == 0).all()


@pytest.fixture(scope="module")
def paged_reference():
    """The reference's interpret-mode paged kernel at G = 12 and 16 over
    ragged slots (bt 8), its output per G."""
    from dnet_tpu.ops.paged_attention import paged_attend as ref_paged_attend

    out = {}
    for G in (12, 16):
        case = _case(G, 8, [0, 5, 8, 61, 140], H=2 * G, KVH=2, cap=160)
        out[G] = case, np.asarray(ref_paged_attend(*(jnp.asarray(a) for a in case), impl="interpret"))
    return out


@pytest.mark.parametrize("G", [12, 16])
def test_paged_plain_matches_reference_kernel(paged_reference, G):
    case, want = paged_reference[G]
    got = paged_attend(*(torch.from_numpy(np.asarray(a)) for a in case)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ---- the row-group grid, block by block -----------------------------------

def _fold(qrows, kt, vt):
    """(m, l, acc) of query rows [R, D] over keys kt / vt [s, D], f32."""
    if kt.shape[0] == 0:
        return (torch.full((qrows.shape[0],), NEG_INF), torch.zeros(qrows.shape[0]),
                torch.zeros(qrows.shape[0], vt.shape[-1]))
    s = qrows @ kt.T
    m = s.amax(dim=-1)
    p = torch.exp(s - m[:, None])
    return m, p.sum(dim=-1), p @ vt


def _merge(states):
    m = torch.stack([s[0] for s in states]).amax(dim=0)
    w = [torch.exp(s[0] - m) for s in states]
    return m, sum(wi * s[1] for wi, s in zip(w, states)), sum(wi[:, None] * s[2] for wi, s in zip(w, states))


def row_group_launch(q, k, v, lengths, n_split, rows):
    """csrc/flash_decode.cu's grid (n_split x RG, KVH, B) block by block:
    block x folds split x // RG's tiles for row group x % RG (rows past G
    zero q rows), publishes its state under its ticket (lane, KV head, row
    group), and the block that brings a ticket to n_split merges and
    writes its row group's heads.  Returns (out with NaN where nothing was
    written, writes per head, blocks per ticket)."""
    B, _, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    RG = row_groups(G, rows)
    scale = D**-0.5
    out = torch.full((B, 1, H, v.shape[-1]), float("nan"))
    writes = torch.zeros(B, H, dtype=torch.int64)
    tickets = {}
    for b in range(B):
        live = int(lengths[b])
        for kvh in range(KVH):
            for x in range(n_split * RG):
                split, r = divmod(x, RG)
                h0, gb = kvh * G + r * rows, min(rows, G - r * rows)
                qrows = torch.zeros(rows, D)
                qrows[:gb] = q[b, 0, h0 : h0 + gb].float() * scale
                keys = [j for t in split_tiles(live, n_split, split) for j in range(t * BK, min((t + 1) * BK, live))]
                state = _fold(qrows, k[b, keys, kvh].float(), v[b, keys, kvh].float())
                ticket = tickets.setdefault((b * KVH + kvh) * RG + r, [])
                ticket.append(state)
                if len(ticket) == n_split:  # the last block of this row group merges
                    m, l, acc = _merge(ticket)
                    res = acc / l.clamp(min=1e-30)[:, None]
                    out[b, 0, h0 : h0 + gb] = res[:gb]
                    writes[b, h0 : h0 + gb] += 1
    return out, writes, {key: len(t) for key, t in tickets.items()}


@pytest.mark.parametrize("G,rows", [(12, 8), (16, 8), (9, 8), (8, 4), (16, 4), (7, 16), (8, 16), (16, 16), (24, 16)])
@pytest.mark.parametrize("n_split", [1, 3, 16])
def test_row_group_grid_folds_each_head_once(rng, G, rows, n_split):
    """Every (lane, KV head, query head) written exactly once, nothing past
    G (no NaN left, none written twice), every ticket counting exactly
    n_split blocks of its own row group, and the outputs the plain
    version's."""
    KVH = 2
    q, k, v = _inputs(rng, 3, KVH * G, KVH, 16, 16)
    lengths = [1, 300, S]
    out, writes, counts = row_group_launch(_t(q), _t(k), _t(v), lengths, n_split, rows)
    RG = row_groups(G, rows)
    assert (writes == 1).all() and not torch.isnan(out).any()
    assert counts == {key: n_split for key in range(3 * KVH * RG)}
    # a merge keyed by (lane, KV head) alone would see RG x n_split blocks
    assert RG == 1 or RG * n_split != n_split
    # the plain version, which test_decode_plain_matches_reference_kernel
    # holds to the reference's kernel
    want = flash_decode_attend(_t(q), _t(k), _t(v), torch.tensor(lengths, dtype=torch.int32), S).numpy()
    np.testing.assert_allclose(out.numpy(), want, **TOL)


def paged_row_group_launch(q, k_pool, v_pool, tables, pos, k_new, v_new, nx, rows=None):
    """csrc/paged_attention.cu's grid (nx x RG, KVH) block by block: block x
    is plan block x // RG for row group x % RG (`split_plan` over nx per
    (KV head, row group)); the last block of a (slot, KV head, row group)
    ticket merges its splits with the new row and writes its heads.  `rows`
    a block: the launcher's (16 for the tensor-core form), by default the
    CUDA-core form's at head dim 64."""
    B, _, H, D = q.shape
    _, bt, KVH, _ = k_pool.shape
    G = H // KVH
    rows = rows or (1 if G == 1 else 4 if G <= 4 else MAX_ROWS)
    RG = row_groups(G, rows)
    nb = tables.shape[1]
    scale = D**-0.5
    splits, first, _ = split_plan(pos.tolist(), nx, 64, nb * bt)
    kf, vf = k_pool.float().reshape(-1, KVH, D), v_pool.float().reshape(-1, KVH, D)
    out = torch.full(q.shape, float("nan"))
    writes = torch.zeros(B, H, dtype=torch.int64)
    tickets = {}
    for kvh in range(KVH):
        for gx in range(nx * RG):
            x, r = divmod(gx, RG)
            owner = [b for b in range(B) if first[b] <= x < first[b] + splits[b]]
            if not owner:
                continue  # past the plan: exits
            b = owner[0]
            split, live = x - first[b], min(int(pos[b]), nb * bt)
            h0, gb = kvh * G + r * rows, min(rows, G - r * rows)
            qrows = torch.zeros(rows, D)
            qrows[:gb] = q[b, 0, h0 : h0 + gb].float() * scale
            keys = [j for t in split_tiles(live, splits[b], split) for j in range(t * 64, min((t + 1) * 64, live))]
            phys = [int(tables[b, j // bt]) * bt + j % bt for j in keys]
            ticket = tickets.setdefault((b * KVH + kvh) * RG + r, [])
            ticket.append(_fold(qrows, kf[phys, kvh], vf[phys, kvh]))
            if len(ticket) == splits[b]:
                new = _fold(qrows, k_new[b, kvh][None].float(), v_new[b, kvh][None].float())
                m, l, acc = _merge([new] + ticket)
                out[b, 0, h0 : h0 + gb] = (acc / l[:, None])[:gb]
                writes[b, h0 : h0 + gb] += 1
    return out, writes, {key: len(t) for key, t in tickets.items()}, splits


@pytest.mark.parametrize("G", [12, 16])
@pytest.mark.parametrize("per_slot", [1, 2, 5])
def test_paged_row_group_grid_folds_each_head_once(paged_reference, G, per_slot):
    case, want = paged_reference[G]
    case = [torch.from_numpy(np.asarray(a)) for a in case]
    B = case[0].shape[0]
    out, writes, counts, splits = paged_row_group_launch(*case, nx=per_slot * B)
    assert (writes == 1).all() and not torch.isnan(out).any()
    assert counts == {(b * 2 + kvh) * 2 + r: splits[b] for b in range(B) for kvh in range(2) for r in range(2)}
    np.testing.assert_allclose(out.numpy(), want, **TOL)


@pytest.mark.parametrize("G", [7, 8, 16, 24])
@pytest.mark.parametrize("per_slot", [1, 3])
def test_paged_row_group_grid_at_16_rows(G, per_slot):
    """The tensor-core form's grid (16 rows a block; G = 24 as 16 + 8 with
    8 masked rows): every head written once, each ticket counting its own
    row group's splits, the outputs the plain version's."""
    case = [torch.from_numpy(np.asarray(a)) for a in _case(G, 8, [0, 5, 8, 61, 140], H=2 * G, KVH=2, cap=160)]
    B, RG = case[0].shape[0], row_groups(G, 16)
    out, writes, counts, splits = paged_row_group_launch(*case, nx=per_slot * B, rows=16)
    assert (writes == 1).all() and not torch.isnan(out).any()
    assert counts == {(b * 2 + kvh) * RG + r: splits[b] for b in range(B) for kvh in range(2) for r in range(RG)}
    np.testing.assert_allclose(out.numpy(), paged_attend(*case).numpy(), **TOL)


# ---- a tiny qwen3_moe at G = 16 through the engine ------------------------

def test_qwen3_moe_group_16_engine_matches_reference(tmp_path):
    """16 query heads over one KV head: prefill logits within 2e-3 and
    identical greedy streams against the reference (its decode kernel in
    interpret mode at G = 16)."""
    from dnet_tpu.core.engine import LocalEngine as RefEngine
    from dnet_tpu.core.types import DecodingParams as RefDecoding
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from tests.fakes.checkpoints import make_tiny_qwen3_moe

    make_tiny_qwen3_moe(tmp_path, {"num_attention_heads": 16, "num_key_value_heads": 1})
    ref = RefEngine(tmp_path, max_seq=64, param_dtype="float32")
    port = LocalEngine(tmp_path, max_seq=64, param_dtype="float32", device="cpu")
    prompt = [256] + list(b"The quick brown fox")
    np.testing.assert_allclose(port.prefill("p", prompt).numpy(), np.asarray(ref.prefill("p", prompt)),
                               atol=2e-3, rtol=2e-3)
    got = [r.token_id for r in port.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]
    assert got == [r.token_id for r in ref.generate(prompt, RefDecoding(), max_tokens=16, nonce="g")]
