"""The decode kernel's split plan and its in-kernel merge, in plain PyTorch,
against dnet_tpu's Pallas decode kernel.

The CUDA decode kernel splits each lane's live tiles over several blocks
(`decode_plan` picks how many), lets each block's 8 warps fold their 8 keys
of every tile with their own online softmax, and merges the warps in each
block and the blocks in the last one to finish, inside the launch.
`flash_decode_split_plain` below is that grouping written out in plain
PyTorch (`split_tiles` gives the tiles each block folds, `kernel_tile` its
keys a tile, as the kernel's `Cfg::BK` picks them); it runs at split
counts 1, 3 and the plan's cap, over lanes of mixed and zero length, in every form: plain,
q8, q4, rotating, MLA widths (192, 128) and the LSE partials.  The
reference runs its real split-K Pallas kernel in interpret mode
(`DNET_FLASH_INTERPRET=1`), one call per lane position, and for the LSE
partials its `_decode_emulate(..., with_lse=True)` (on the f32 shard
`read_kv` dequantizes, for codes).  Tolerance: f32 2e-5
(tests/test_flash_decode.py:41); acc within it relative to l.
"""

from typing import Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu_torch.core.kvcache import _quantize_q4, _quantize_q8, read_kv
from dnet_tpu_torch.ops.flash_decode import (
    BK,
    MAX_SPLITS,
    MIN_TILES_PER_SPLIT,
    DECODE_BLOCKS,
    NEG_INF,
    decode_plan,
    flash_decode_attend,
    flash_decode_lse,
)

pytestmark = pytest.mark.core

TOL = dict(atol=2e-5, rtol=2e-5)
S = 512
SPLITS = [1, 3, MAX_SPLITS]
# DeepSeek-V2-Lite's softmax scale: 192^-0.5 x YaRN's mscale(40, 0.707)^2
MLA_SCALE = 192**-0.5 * (0.1 * 0.707 * np.log(40) + 1.0) ** 2


# a decode kernel block's warps, each folding an eighth of every tile
# (csrc/flash_decode.cu's NWARPS)
NWARPS = 8


def kernel_tile(row_bytes: int) -> int:
    """Keys per tile of the decode kernel whose K and V rows take
    `row_bytes` together as the cache stores them: 32 where a BK-key tile
    would pass 32 KB (MLA widths in bf16 or f32), else BK."""
    return 32 if BK * row_bytes > 32768 else BK


def split_tiles(live: int, n_split: int, split: int, tile: int = BK) -> range:
    """The `tile`-key tiles that block `split` of the `n_split` sharing a
    lane of `live` slots folds: ceil(tiles / n_split) each, the last ones
    empty when the lane is short."""
    n_tiles = -(-live // tile)
    per = -(-n_tiles // n_split)
    begin = min(split * per, n_tiles)
    return range(begin, min(begin + per, n_tiles))


def flash_decode_split_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    n_split: int,
    scale: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    rotating: bool = False,
    window: int = 0,
    with_lse: bool = False,
):
    """The CUDA kernel's own grouping of the fold in plain PyTorch: lane b's live tiles
    (of `kernel_tile` keys) split over `n_split` blocks (`split_tiles`),
    each block's NWARPS warps folding their eighth of every tile with their
    own online softmax (a warp skips a tile whose keys all lie past the
    lane's live slots), the warps merged per block and the blocks per
    (lane, KV head) with one log-sum-exp each, as the last block to finish
    does.  Returns flash_decode_attend's output, or with `with_lse`
    flash_decode_lse's (acc, m, l)."""
    B, _, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = D**-0.5 if scale is None else float(scale)
    tensors = {"k": k, "v": v}
    if k_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    kf, vf = (t.float() for t in read_kv(tensors))
    Dv = vf.shape[-1]
    qf = q[:, 0].float().reshape(B, KVH, G, D) * scale
    lens = [int(x) for x in lengths.tolist()]
    tile = kernel_tile(k.shape[-1] * k.element_size() + v.shape[-1] * v.element_size())
    warp_keys = tile // NWARPS

    def merge(parts):
        m = torch.stack([p[0] for p in parts]).amax(dim=0)
        w = [torch.exp(p[0] - m) for p in parts]
        return m, sum(wi * p[1] for wi, p in zip(w, parts)), sum(wi[..., None] * p[2] for wi, p in zip(w, parts))

    acc = torch.zeros(B, KVH, G, Dv)
    m_out = torch.full((B, KVH, G), NEG_INF)
    l_out = torch.zeros(B, KVH, G)
    for b, length in enumerate(lens):
        live, pos = min(length, S), length - 1
        blocks = []
        for split in range(n_split):
            warps = []
            for w in range(NWARPS):
                m = torch.full((KVH, G), NEG_INF)
                l = torch.zeros(KVH, G)
                a = torch.zeros(KVH, G, Dv)
                for t in split_tiles(live, n_split, split, tile):
                    j0 = t * tile + w * warp_keys
                    if j0 >= live:
                        continue
                    slot = torch.arange(j0, j0 + warp_keys)
                    valid = slot < live
                    if rotating:
                        k_abs = pos - torch.remainder(pos - slot, S)
                        valid = valid & (k_abs >= 0) & (k_abs > pos - window)
                    rows = slot.clamp(max=S - 1)
                    # rows past the live slots arrive zero-filled
                    kt = torch.where((slot < live)[:, None, None], kf[b, rows], 0.0)
                    vt = torch.where((slot < live)[:, None, None], vf[b, rows], 0.0)
                    scores = torch.where(valid, torch.einsum("kgd,skd->kgs", qf[b], kt), NEG_INF)
                    m_new = torch.maximum(m, scores.amax(dim=-1))
                    p = torch.exp(scores - m_new[..., None])
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(dim=-1)
                    a = a * corr[..., None] + torch.einsum("kgs,skd->kgd", p, vt)
                    m = m_new
                warps.append((m, l, a))
            blocks.append(merge(warps))
        m_out[b], l_out[b], acc[b] = merge(blocks)
    if with_lse:
        return acc.reshape(B, 1, H, Dv), m_out, l_out
    sink = torch.full((KVH, G), NEG_INF) if sinks is None else sinks.float().reshape(KVH, G)
    m_fin = torch.maximum(m_out, sink)
    corr = torch.exp(m_out - m_fin)
    l_fin = torch.clamp(l_out * corr + torch.exp(sink - m_fin), min=1e-30)
    return (acc * corr[..., None] / l_fin[..., None]).reshape(B, 1, H, Dv).to(q.dtype)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DNET_FLASH_INTERPRET", "1")


@pytest.mark.parametrize("live,blocks,want", [
    (0, 8, 1),  # an empty rank still launches one block per KV head
    (114, 8, 1),  # two tiles: one split holds both
    (300, 8, 3),
    (2048, 8, MAX_SPLITS),  # the cap: 16 splits of 2 tiles, 128 blocks
    (4096, 16, 8),  # MLA's 16 KV heads: 128 blocks
    (1500, 64, 2),  # 8 lanes x 8 KV heads
    (4096, 264, 1),
])
def test_decode_plan(live, blocks, want):
    n = decode_plan(live, blocks)
    assert n == want
    n_tiles = -(-max(live, 1) // BK)
    assert 1 <= n <= MAX_SPLITS
    assert n == 1 or (n - 1) * MIN_TILES_PER_SPLIT < n_tiles
    assert n == 1 or n * blocks <= DECODE_BLOCKS


@pytest.mark.parametrize("n_split", [1, 2, 3, MAX_SPLITS, 16])
@pytest.mark.parametrize("live", [0, 1, 64, 65, 300, 2048, 4096])
def test_split_tiles_cover_each_live_tile_once(live, n_split):
    tiles = [t for s in range(n_split) for t in split_tiles(live, n_split, s)]
    assert tiles == list(range(-(-live // BK)))
    sizes = [len(split_tiles(live, n_split, s)) for s in range(n_split)]
    assert max(sizes) == -(-(-(-live // BK)) // n_split)  # ceil(tiles / n_split) each
    assert sizes == sorted(sizes, reverse=True)  # a short lane's empty splits are the last


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(np.asarray(a))


def _inputs(rng, B, H, KVH, Dqk, Dv, S=S):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(B, 1, H, Dqk), f(B, S, KVH, Dqk), f(B, S, KVH, Dv)


def _codes(bits, k, v):
    """The port's codes and scales (bit-equal to the reference's,
    tests/test_torch_kv_quant.py) as numpy arrays."""
    quantize = _quantize_q8 if bits == 8 else _quantize_q4
    kq, ks = quantize(_t(k))
    vq, vs = quantize(_t(v))
    return {"k": kq.numpy(), "k_scale": ks.numpy(), "v": vq.numpy(), "v_scale": vs.numpy()}


def _ref_lane(q, cache, pos, scale=None, sinks=None, rotating=False, window=0):
    """The reference kernel's output for one lane at `pos`."""
    from dnet_tpu.ops.flash_decode import flash_decode_attend as ref_decode
    from dnet_tpu.ops.flash_decode import flash_decode_eligible

    assert flash_decode_eligible(_j(q), _j(cache["k"]))
    return np.asarray(ref_decode(
        _j(q), _j(cache["k"]), _j(cache["v"]), jnp.int32(pos), scale=scale, sinks=_j(sinks), window=window,
        rotating=rotating, k_scale=_j(cache.get("k_scale")), v_scale=_j(cache.get("v_scale")),
    ))


def _check_lanes(q, cache, lengths, n_split, scale=None, sinks=None, rotating=False, window=0):
    """The split emulation over lanes of mixed lengths (one launch's worth)
    against one reference call per lane; a lane of length 0 gives zeros."""
    got = flash_decode_split_plain(
        _t(q), _t(cache["k"]), _t(cache["v"]), torch.tensor(lengths, dtype=torch.int32), n_split, scale=scale,
        sinks=_t(sinks), k_scale=_t(cache.get("k_scale")), v_scale=_t(cache.get("v_scale")), rotating=rotating,
        window=window,
    ).numpy()
    assert got.shape == q.shape[:3] + (cache["v"].shape[-1] * (2 if cache["v"].dtype == np.uint8 else 1),)
    for b, length in enumerate(lengths):
        if length == 0:
            assert not got[b].any()
            continue
        lane = {n: a[b : b + 1] for n, a in cache.items()}
        want = _ref_lane(q[b : b + 1], lane, length - 1, scale, sinks, rotating, window)
        np.testing.assert_allclose(got[b : b + 1], want, **TOL)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("H,KVH", [(4, 4), (8, 2), (16, 2)])  # G = 1, 4 and 8
def test_plain_form_matches_reference_kernel(rng, n_split, H, KVH):
    """Lanes at a tile edge, a warp edge (8 keys), mid-tile, the last slot,
    and an idle one, in one emulated launch."""
    q, k, v = _inputs(rng, 5, H, KVH, 16, 16)
    _check_lanes(q, {"k": k, "v": v}, [1, 9, 0, 300, S], n_split)


@pytest.mark.parametrize("n_split", SPLITS)
def test_sinks_match_reference_kernel(rng, n_split):
    q, k, v = _inputs(rng, 2, 8, 2, 16, 16)
    sinks = rng.normal(size=(8,)).astype(np.float32)
    _check_lanes(q, {"k": k, "v": v}, [257, 64], n_split, sinks=sinks)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n_split", SPLITS)
def test_quantized_forms_match_reference_kernel(rng, bits, n_split):
    q, k, v = _inputs(rng, 3, 8, 2, 16, 16)
    _check_lanes(q, _codes(bits, k, v), [0, 65, 450], n_split)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("n_split", SPLITS)
def test_mla_widths_match_reference_kernel(rng, bits, n_split):
    """(Dqk, Dv) = (192, 128), G = 1, DeepSeek-V2-Lite's scale."""
    q, k, v = _inputs(rng, 3, 2, 2, 192, 128)
    cache = _codes(bits, k, v) if bits else {"k": k, "v": v}
    _check_lanes(q, cache, [300, 0, 129], n_split, scale=MLA_SCALE)


W = 128  # gpt-oss-20b's sliding window


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("window", [W, 5])
def test_rotating_form_matches_reference_kernel(rng, bits, n_split, window):
    """A ring of W slots, lanes before, at and past the wrap (lengths may
    exceed W), with sinks; a window of 5 leaves most warps' key slices
    wholly masked."""
    q, k, v = _inputs(rng, 4, 16, 2, 16, 16, S=W)
    cache = _codes(bits, k, v) if bits else {"k": k, "v": v}
    sinks = rng.normal(size=(16,)).astype(np.float32)
    _check_lanes(q, cache, [1, W, W + 40, 4096], n_split, sinks=sinks, rotating=True, window=window)


def _ref_lse(q, cache, live, scale, S_local):
    """The reference's LSE partials for one rank of S_local slots whose first
    `live` are attended (the emulation at pos = live - 1, offset 0; an empty
    rank as a shard wholly past pos)."""
    from dnet_tpu.core.kvcache import read_kv
    from dnet_tpu.ops.flash_attention import _pick_tile
    from dnet_tpu.ops.flash_decode import _decode_emulate

    k, v = (cache["k"], cache["v"]) if "k_scale" not in cache else read_kv({n: _j(a) for n, a in cache.items()})
    H, KVH = q.shape[2], k.shape[2]
    G = H // KVH
    pos, offset = (live - 1, 0) if live else (0, S_local)
    acc, m, l = _decode_emulate(
        _j(q), _j(k), _j(v), jnp.asarray([pos, offset], jnp.int32), jnp.full((KVH, G), NEG_INF, jnp.float32), G=G,
        scale=float(scale or q.shape[-1] ** -0.5), bk=_pick_tile(S_local, 256), window=0, rotating=False, with_lse=True)
    return np.asarray(acc), np.asarray(m), np.asarray(l)


@pytest.mark.parametrize("form", ["plain", "q8", "q4", "mla", "mla_q8", "mla_q4"])
@pytest.mark.parametrize("n_split", SPLITS)
def test_lse_form_matches_reference_emulation(rng, form, n_split):
    """One sp rank's partials over lanes of mixed length, a lane of length 0
    among them: m and l within 2e-5, acc within it relative to l, and the
    empty lane exactly (0, NEG_INF, 0)."""
    mla = form.startswith("mla")
    bits = int(form[-1]) if form[-2] == "q" else 0
    H, KVH, Dqk, Dv = (2, 2, 192, 128) if mla else (8, 2, 16, 16)
    scale = MLA_SCALE if mla else None
    S_local = 256
    q, k, v = _inputs(rng, 3, H, KVH, Dqk, Dv, S=S_local)
    cache = _codes(bits, k, v) if bits else {"k": k, "v": v}
    lengths = [200, 0, S_local]
    acc, m, l = flash_decode_split_plain(
        _t(q), _t(cache["k"]), _t(cache["v"]), torch.tensor(lengths, dtype=torch.int32), n_split, scale=scale,
        k_scale=_t(cache.get("k_scale")), v_scale=_t(cache.get("v_scale")), with_lse=True)
    assert acc.shape == (3, 1, H, Dv) and m.shape == l.shape == (3, KVH, H // KVH)
    for b, live in enumerate(lengths):
        lane = {n: a[b : b + 1] for n, a in cache.items()}
        w_acc, w_m, w_l = _ref_lse(q[b : b + 1], lane, live, scale, S_local)
        np.testing.assert_allclose(m[b : b + 1].numpy(), w_m, **TOL)
        np.testing.assert_allclose(l[b : b + 1].numpy(), w_l, **TOL)
        norm = np.maximum(w_l, 1e-30).reshape(1, 1, H, 1)
        np.testing.assert_allclose(acc[b : b + 1].numpy() / norm, w_acc / norm, **TOL)
        if live == 0:
            assert (m[b] == NEG_INF).all() and (l[b] == 0).all() and (acc[b] == 0).all()


@pytest.mark.parametrize("n_split", SPLITS)
def test_split_emulation_matches_the_cpu_wrappers(rng, n_split):
    """The emulated grouping and the wrappers' plain versions (the 64-key
    tile fold) compute one function: equal within 2e-5 on one launch's
    mixed lanes, normalised and LSE."""
    q, k, v = (_t(a) for a in _inputs(rng, 4, 8, 2, 16, 16))
    lengths = torch.tensor([0, 33, 400, S], dtype=torch.int32)
    got = flash_decode_split_plain(q, k, v, lengths, n_split)
    np.testing.assert_allclose(got.numpy(), flash_decode_attend(q, k, v, lengths, S).numpy(), **TOL)
    acc, m, l = flash_decode_split_plain(q, k, v, lengths, n_split, with_lse=True)
    w_acc, w_m, w_l = flash_decode_lse(q, k, v, lengths, S)
    np.testing.assert_allclose(m.numpy(), w_m.numpy(), **TOL)
    np.testing.assert_allclose((l / w_l.clamp(min=1e-30)).numpy()[w_l.numpy() > 0], 1.0, **TOL)
    norm = w_l.clamp(min=1e-30).reshape(4, 1, 8, 1)
    np.testing.assert_allclose((acc / norm).numpy(), (w_acc / norm).numpy(), **TOL)
