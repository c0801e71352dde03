"""The port's sequence-parallel ops at MLA widths, over quantized caches and
with gpt_oss's masks, against dnet_tpu's.

The same numpy inputs go through the reference inside `shard_map` over two
of the 8 forced CPU devices (tests/conftest.py), with
DNET_FLASH_INTERPRET=1 so its sp decode runs the kernel's jnp tile-fold
emulation as its own tests run it, and through the port with both ranks on
the CPU (plain versions).

- the decode kernel's LSE form at (Dqk, Dv) = (192, 128) with G = 1, and
  over int8 / packed-int4 codes at (64, 64) and (192, 128): m and l within
  2e-5 in f32 and acc within 2e-5 relative to l (tests/test_flash_decode.py:41)
  against `_decode_emulate(..., with_lse=True)`, which the reference runs on
  the f32 shard `read_kv` dequantizes; the port reads the codes.  Ranks with
  live slots and a rank wholly past pos;
- `sp_flash_decode_attend`, `sp_decode_attend` and the whole sp
  `cached_attend` (write, then the LSE form for a decode row or the dense
  `sp_decode_attend` for a prompt chunk) at (192, 128), plain and
  quantized, at positions 10, 45 and 63 in S = 64, with DeepSeek-V2-Lite's
  softmax scale: 2e-5;
- gpt_oss's rank-local masks (`GptOssRingModel.sp_kind_masks`) equal the
  reference's `_kind_mask` under sp, both kinds, with and without a window,
  and the dense sp attention with sinks folded once after the combine
  matches the reference's: 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from dnet_tpu.utils.jax_compat import shard_map
from dnet_tpu_torch.core.kvcache import _quantize_q4, _quantize_q8
from dnet_tpu_torch.ops.attention import cached_attend
from dnet_tpu_torch.ops.flash_decode import NEG_INF, flash_decode_lse, rank_live, sp_lengths
from dnet_tpu_torch.ops.ring_attention import sp_decode_attend, sp_flash_decode_attend
from dnet_tpu_torch.parallel.mesh import SpGroup

pytestmark = [pytest.mark.core, pytest.mark.parallel]

TOL = dict(atol=2e-5, rtol=2e-5)
S = 64
# DeepSeek-V2-Lite's softmax scale: 192^-0.5 x YaRN's mscale(40, 0.707)^2
MLA_SCALE = 192**-0.5 * (0.1 * 0.707 * np.log(40) + 1.0) ** 2
WIDTHS = {"llama": (4, 2, 64, 64), "mla": (2, 2, 192, 128)}  # H, KVH, Dqk, Dv


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DNET_FLASH_INTERPRET", "1")


def _mesh(devices):
    return Mesh(np.array(devices[:2]), ("sp",))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(seed, widths, T=1, S=S):
    H, KVH, Dqk, Dv = WIDTHS[widths]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(1, T, H, Dqk), f(1, S, KVH, Dqk), f(1, S, KVH, Dv)


def _codes(bits, k, v):
    """The port's codes and scales for f32 k/v (bit-equal to the
    reference's, tests/test_torch_kv_quant.py), as a cache dict."""
    quantize = _quantize_q8 if bits == 8 else _quantize_q4
    kq, ks = quantize(_t(k))
    vq, vs = quantize(_t(v))
    return {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}


def _ref_read_kv(cache: dict):
    """The reference's read_kv on the same codes: the f32 shard its sp
    decode reads."""
    from dnet_tpu.core.kvcache import read_kv

    k, v = read_kv({n: jnp.asarray(t.numpy()) for n, t in cache.items()})
    return np.asarray(k), np.asarray(v)


# the plain (64, 64) form is held by tests/test_torch_sp.py
@pytest.mark.parametrize("widths,bits", [("mla", 0), ("mla", 8), ("mla", 4), ("llama", 8), ("llama", 4)])
@pytest.mark.parametrize("pos,offset", [(10, 0), (45, 32), (45, 0), (20, 32), (63, 32), (0, 0)])
def test_lse_plain_matches_reference_emulation(widths, bits, pos, offset):
    """One rank of 32 slots at `offset`: (20, 32) is a rank wholly past pos
    (m = NEG_INF, l = 0, acc = 0 on both sides).  Quantized: the port reads
    the codes, the reference emulation the shard read_kv dequantized."""
    from dnet_tpu.ops.flash_attention import _pick_tile
    from dnet_tpu.ops.flash_decode import _decode_emulate

    H, KVH, Dqk, Dv = WIDTHS[widths]
    q, k, v = _inputs(pos * 3 + offset + bits, widths, S=32)
    cache = _codes(bits, k, v) if bits else {"k": _t(k), "v": _t(v)}
    k_ref, v_ref = _ref_read_kv(cache) if bits else (k, v)
    G = H // KVH
    scale = MLA_SCALE if widths == "mla" else None
    want = _decode_emulate(jnp.asarray(q), jnp.asarray(k_ref), jnp.asarray(v_ref),
                           jnp.asarray([pos, offset], jnp.int32), jnp.full((KVH, G), NEG_INF, jnp.float32), G=G,
                           scale=float(scale or Dqk**-0.5), bk=_pick_tile(32, 256), window=0, rotating=False,
                           with_lse=True)
    live = rank_live(pos, offset // 32, 32)
    lengths = torch.full((1,), live, dtype=torch.int32)
    acc, m, l = flash_decode_lse(_t(q), cache["k"], cache["v"], lengths, live, scale=scale,
                                 k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
    w_acc, w_m, w_l = (np.asarray(x) for x in want)
    assert acc.shape == (1, 1, H, Dv) and m.shape == l.shape == (1, KVH, G)
    np.testing.assert_allclose(m.numpy(), w_m, **TOL)
    np.testing.assert_allclose(l.numpy(), w_l, **TOL)
    norm = np.maximum(w_l, 1e-30).reshape(1, 1, H, 1)
    np.testing.assert_allclose(acc.numpy() / norm, w_acc / norm, **TOL)
    if live == 0:
        assert (m == NEG_INF).all() and (l == 0).all() and (acc == 0).all()


def _ref_sp_flash(q, k, v, pos, devices, scale):
    from dnet_tpu.ops.flash_decode import sp_flash_decode_attend as ref

    def body(q, k, v):
        return ref(q, k, v, jnp.int32(pos), "sp", scale=scale)

    return np.asarray(shard_map(body, mesh=_mesh(devices), in_specs=(P(), P(None, "sp"), P(None, "sp")),
                                out_specs=P())(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("pos", [10, 45, 63])
def test_sp_flash_decode_mla_matches_reference(eight_devices, bits, pos):
    """Two ranks of 32 slots at (192, 128), G = 1, DeepSeek-V2-Lite's scale;
    quantized: each rank's codes against the reference on read_kv's shard."""
    q, k, v = _inputs(100 + pos + bits, "mla")
    cache = _codes(bits, k, v) if bits else {"k": _t(k), "v": _t(v)}
    k_ref, v_ref = _ref_read_kv(cache) if bits else (k, v)
    want = _ref_sp_flash(q, k_ref, v_ref, pos, eight_devices, MLA_SCALE)
    sp = SpGroup(["cpu", "cpu"])
    shards = [{n: t[:, r * 32 : (r + 1) * 32].contiguous() for n, t in cache.items()} for r in range(2)]
    got = sp_flash_decode_attend(
        _t(q), [c["k"] for c in shards], [c["v"] for c in shards], sp_lengths(1, pos, 32, sp.devices),
        [rank_live(pos, r, 32) for r in range(2)], sp, scale=MLA_SCALE,
        k_scales=[c["k_scale"] for c in shards] if bits else None,
        v_scales=[c["v_scale"] for c in shards] if bits else None,
    )
    assert got.shape == (1, 1, 2, 128)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("T,pos", [(1, 10), (1, 45), (1, 63), (16, 20)])
def test_sp_decode_attend_mla_matches_reference(eight_devices, bits, T, pos):
    """The dense sp attention at (192, 128) under each rank's causal mask,
    DeepSeek-V2-Lite's scale: decode rows and a prompt chunk across the
    boundary at 32, over a plain shard or read_kv's dequantized one."""
    from dnet_tpu.ops.attention import sp_causal_mask as ref_mask
    from dnet_tpu.ops.ring_attention import sp_decode_attend as ref

    from dnet_tpu_torch.core.kvcache import read_kv
    from dnet_tpu_torch.ops.attention import sp_causal_mask

    q, k, v = _inputs(200 + T + pos + bits, "mla", T=T)
    cache = _codes(bits, k, v) if bits else {"k": _t(k), "v": _t(v)}
    k_ref, v_ref = _ref_read_kv(cache) if bits else (k, v)

    def body(k, v):
        return ref(jnp.asarray(q), k, v, ref_mask(T, S // 2, jnp.int32(pos), "sp"), "sp", scale=MLA_SCALE)

    want = shard_map(body, mesh=_mesh(eight_devices), in_specs=(P(None, "sp"), P(None, "sp")),
                     out_specs=P())(jnp.asarray(k_ref), jnp.asarray(v_ref))
    shards = [read_kv({n: t[:, r * 32 : (r + 1) * 32] for n, t in cache.items()}) for r in range(2)]
    got = sp_decode_attend(_t(q), [kr for kr, _ in shards], [vr for _, vr in shards],
                           [sp_causal_mask(T, 32, pos, r) for r in range(2)], SpGroup(["cpu", "cpu"]), scale=MLA_SCALE)
    assert got.shape == (1, T, 2, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("T,pos", [(1, 10), (1, 63), (16, 20)])
def test_sp_cached_attend_mla_matches_reference(eight_devices, bits, T, pos):
    """The whole sp branch of cached_attend at (192, 128), causal: each new
    key written on its owner rank (quantized when the cache is), then a
    decode row through the LSE form or a prompt chunk (16 rows across the
    boundary at 32) through the dense sp attention.  Outputs within 2e-5,
    the shards equal afterwards (codes and scales bit for bit; the
    reference runs eagerly: under jit XLA may round a scale 1 ulp apart)."""
    from dnet_tpu.ops.attention import cached_attend as ref

    H, KVH, Dqk, Dv = WIDTHS["mla"]
    rng = np.random.default_rng(bits * 100 + T + pos)
    q = rng.normal(size=(1, T, H, Dqk)).astype(np.float32)
    k_new = rng.normal(size=(1, T, KVH, Dqk)).astype(np.float32)
    v_new = rng.normal(size=(1, T, KVH, Dv)).astype(np.float32)
    _, k_old, v_old = _inputs(7 + bits, "mla")
    cache = _codes(bits, k_old, v_old) if bits else {"k": _t(k_old), "v": _t(v_old)}

    def body(kvs):
        return ref(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), kvs, jnp.int32(pos), None, sp_axis="sp",
                   scale=MLA_SCALE, causal=True)

    want, want_kvs = shard_map(body, mesh=_mesh(eight_devices), in_specs=(P(None, "sp"),),
                               out_specs=(P(), P(None, "sp")))({n: jnp.asarray(t.numpy()) for n, t in cache.items()})
    ranks = [{n: t[:, r * 32 : (r + 1) * 32].clone() for n, t in cache.items()} for r in range(2)]
    got, ranks = cached_attend(_t(q), _t(k_new), _t(v_new), ranks, pos, None, scale=MLA_SCALE, causal=True,
                               sp=SpGroup(["cpu", "cpu"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for n in cache:
        assert np.array_equal(torch.cat([c[n] for c in ranks], dim=1).numpy(), np.asarray(want_kvs[n])), n


def _oss_pair(sliding_window):
    """The reference's and the port's gpt_oss model on the tiny config
    (window 8, or none)."""
    from dnet_tpu.models import ModelConfig as RefConfig
    from dnet_tpu.models.gpt_oss import GptOssRingModel as RefModel
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.models.gpt_oss import GptOssRingModel
    from tests.fakes.checkpoints import TINY_GPT_OSS_CONFIG

    d = dict(TINY_GPT_OSS_CONFIG, sliding_window=sliding_window)
    layers = range(d["num_hidden_layers"])
    return RefModel(RefConfig.from_hf(d), layers), GptOssRingModel(ModelConfig.from_hf(d), layers, "cpu")


@pytest.mark.parametrize("window", [8, 0])
@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("T,pos", [(1, 10), (1, 45), (16, 20), (24, 40)])
def test_gpt_oss_sp_masks_and_sink_fold_match_reference(eight_devices, window, kind, T, pos):
    """gpt_oss's sp masks per kind (sliding: the configured window, or the
    whole sequence, S_local x R, without one), then the dense sp attention
    with per-head sinks folded once after the combine."""
    from dnet_tpu.ops.ring_attention import sp_decode_attend as ref

    ref_model, model = _oss_pair(window)
    H, KVH, Hd = 4, 2, 16
    rng = np.random.default_rng(window * 10 + kind + T + pos)
    q = rng.normal(size=(1, T, H, Hd)).astype(np.float32)
    k, v = (rng.normal(size=(1, S, KVH, Hd)).astype(np.float32) for _ in range(2))
    sinks = rng.normal(size=(H,)).astype(np.float32)

    def body(k, v):
        mask = ref_model._kind_mask(kind, T, S // 2, jnp.int32(pos), "sp", None)
        out = ref(jnp.asarray(q), k, v, mask, "sp", sinks=jnp.asarray(sinks))
        return out, mask[None]

    want, ref_masks = shard_map(body, mesh=_mesh(eight_devices), in_specs=(P(None, "sp"), P(None, "sp")),
                                out_specs=(P(), P("sp")))(jnp.asarray(k), jnp.asarray(v))
    sp = SpGroup(["cpu", "cpu"])
    masks = model.sp_kind_masks(kind, T, S // 2, pos, sp)
    assert [m.numpy().tolist() for m in masks] == np.asarray(ref_masks).tolist()
    got = sp_decode_attend(_t(q), list(_t(k).split(S // 2, dim=1)), list(_t(v).split(S // 2, dim=1)), masks, sp,
                           sinks=_t(sinks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
