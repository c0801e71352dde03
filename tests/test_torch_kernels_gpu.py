"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and skips without one.  The file imports neither jax
nor dnet_tpu, so it runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

The prefill kernel runs at every width pair it is built for, (64, 64),
(128, 128) and MLA's (192, 128), in bf16 (tensor cores) and f32, at G = 1,
4 and 8 with two batch rows, T and pos off its tile grids, chunks that end
at the cache's last slot, sinks, and caches whose dead slots hold NaN, and
calls large enough for its 128-row tiles; one device kernel a call.  Its
per-lane form (the batched speculative verify: each lane's chunk at its
own start) runs at every width pair and both dtypes, B = 8 lanes, T = 5
and 8, starts spread over 0 to 4,000 with NaN past each lane's live rows,
on its own counter, one device kernel a call, each lane equal to the
scalar form at its start; the speculating engines (single sequence, and
dense batched slots with a sampled lane beside three greedy ones) run on
the card against the CPU.  Otherwise shapes are Llama-3.2-1B's (H=32, KVH=8,
D=64); the decode kernel reads a
plain cache (also bf16 under an f32 q, as DNET_KV_BITS=16 gives an f32
model) and int8 / packed-int4 caches written by the port's write_kv, with a
lengths vector of ragged lanes (an idle one included), and its rotating
variant gpt-oss-20b's sliding-window ring (H=64, KVH=8, W=128, sinks) in
every cache form; prefill and decode at DeepSeek-V2-Lite's MLA widths
(H = KVH = 16, (Dqk, Dv) = (192, 128), its softmax scale) in bf16, f32 and
over q8 / q4 caches, counted on their own MLA counters; the paged kernel
reads a block pool (bf16 under an f32 q too) through shuffled page tables at
ragged per-slot lengths, bt 8 to 128, G = 1, 3, 4 and 8 at head dims 64 and
128, every blocks-a-slot budget up to the cap, one device kernel a call, and
interleaved with decode calls repeating bit for bit.  Groups wider than a
block's 8 query rows (G = 9, 12, 16, 32; row groups of blocks) run the
decode kernel in the plain, q8, q4 and LSE forms at head dims 64 and 128
with split counts up to the cap, the paged kernel at G = 12 and 16 over bt
16 and 64, and the prefill kernel at (128, 128) with G = 16, each on its
wide counter, one device kernel a call, interleaved with narrow calls
repeating bit for bit; G = 8 at head dim 128 runs in both of its layouts.
The tensor-core forms (bf16 over bf16 at head dim 128, G >= 5) run the
decode kernel normalised and LSE at G = 5, 7, 8, 12, 16 and 24 over lanes
at every tile edge of a 4096-slot cache, split counts up to the cap and
sinks, and the paged kernel at G = 7, 8, 16 and 24 and every few budgets,
within MMA_TOL (tests/test_torch_decode_mma.py), each call counted on
launches_mma.
The decode kernel's LSE form (one sequence-
parallel rank's unnormalised partials) runs on R = 2 and 4 shards of a
4096-slot cache at Llama-3.2-1B's and at head dim 128's widths, an empty
rank included: m and the rank's output acc / l within the decode
tolerances, l within them relative to itself, and the combined ranks
against the decode kernel over the whole cache; so do its MLA-width
(192, 128) and its int8 / int4 code forms, each on its own counter.  The engines with a bf16
cache under f32 params, and the sp engine (llama; deepseek_v2 and gpt_oss,
plain and q8 / q4), run on the card against the CPU's plain versions.  The
hop codec's column kernels run at its widths (C=2048) and at odd ones, with
R=1 frames: norms within 2e-5 relative in f32 (1e-2 in bf16 inputs summed
in f32); the one-launch norms + top-k at R = 1 / 7 / 1500, C = 2048 / 2880
/ 8192, keep = 1 / C/2 / C, ties, NaN and inf, equal bit for bit to
topk_columns of its own norms, one device kernel a call; gather and dequant-scatter equal bit for bit (both also at R = 1, 7 and
1500: the gather with odd C, one kept column, every column, a span past its
window and an unsorted idx; the dequant-scatter with empty strips, every
column kept and odd D).  Every one-kernel-a-call case is traced in a fresh
process (tests/torch_gpu_trace.py; the helper's own check traces one known
elementwise kernel).  The weight quantizer at a Llama-3.3-70B MLP weight's
size gives the CPU's codes, scales and dequantized weight bit for bit.  A
weight-streaming engine (plan (2, 1)) matches the CPU's.
Tolerances: f32 1e-4 (sums
in another order); bf16 2e-2 against the plain version computed in f32
from the same bf16 inputs (the kernel rounds its output to bf16, ~4e-3 at
|x| ~ 1, and sums in another order).
"""

import math

import pytest
import torch

from dnet_tpu_torch.compression.ops import (
    column_sq_norms,
    column_sq_norms_plain,
    column_topk,
    pack_mask,
    topk_columns,
    dequant_scatter_columns,
    dequant_scatter_columns_plain,
    gather_columns,
    gather_columns_plain,
    quantize_q8,
)
from dnet_tpu_torch.ops.flash_attention import flash_prefill, flash_prefill_plain
from dnet_tpu_torch.core.kvcache import KVConfig, init_cache, layer_slices, write_kv, write_kv_rotating
from dnet_tpu_torch.ops.flash_decode import (
    MMA_TOL,
    NEG_INF,
    decode_lengths,
    flash_decode_attend,
    flash_decode_lse,
    flash_decode_lse_plain,
    flash_decode_plain,
    rank_live,
    sp_lengths,
)
from dnet_tpu_torch.ops.ring_attention import lse_combine
from dnet_tpu_torch.parallel.mesh import SpGroup
from dnet_tpu_torch.ops.paged_attention import paged_attend, paged_attend_plain
from torch_gpu_trace import trace_all

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.fixture(scope="module")
def traced():
    """Every TRACED case's device kernels, each traced in a fresh process
    (tests/torch_gpu_trace.py), all at the first test that asks, every
    source built first so that the processes only load the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dnet_tpu_torch.kernels.build import build_all

    build_all()
    return trace_all(TRACED)


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


# (Dqk, Dv) pairs of the prefill kernel: Llama-3.2-1B's, Llama-3-8B's /
# Qwen's, DeepSeek-V2-Lite's MLA
PREFILL_WIDTHS = [(64, 64), (128, 128), (192, 128)]


def _prefill_case(gen, dtype, dqk, dv, G, B, T, pos, S, sinks, KVH=2):
    q = _randn(gen, dtype, B, T, KVH * G, dqk)
    k, v = _randn(gen, dtype, B, S, KVH, dqk), _randn(gen, dtype, B, S, KVH, dv)
    sk = torch.randn(KVH * G, generator=gen, device="cuda") if sinks else None
    return q, k, v, sk, (MLA_SCALE if dqk == MLA_DQK else None)


@pytest.mark.parametrize("dqk,dv", PREFILL_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("T,pos,S,sinks", [(77, 45, 200, True), (50, 14, 64, False), (130, 126, 256, True)])
def test_prefill_kernel_width_pairs(gen, dqk, dv, dtype, G, T, pos, S, sinks):
    """Every width pair in bf16 (tensor cores, heads stacked into rows) and
    f32, G = 1 / 4 / 8, two batch rows, T and pos off the 64-row and 64-key
    grids, chunks that end at the cache's last slot (pos + T = S), with and
    without sinks: one launch on the width's counter, within tolerance."""
    q, k, v, sk, scale = _prefill_case(gen, dtype, dqk, dv, G, 2, T, pos, S, sinks)
    attr = "launches" if dqk == dv else "launches_mla"
    before = getattr(flash_prefill, attr)
    out = flash_prefill(q, k, v, pos, scale=scale, sinks=sk)
    torch.cuda.synchronize()
    assert getattr(flash_prefill, attr) == before + 1
    want = flash_prefill_plain(q.float(), k.float(), v.float(), pos, scale=scale, sinks=sk)
    assert out.shape == (2, T, q.shape[2], dv) and out.dtype == dtype
    assert (out.float() - want).abs().max().item() <= TOL[dtype]


# the per-lane form's lane starts: an idle lane at 0, tile edges, and the
# spread of a batch of long and short conversations
LANE_STARTS = [0, 63, 100, 511, 1024, 2047, 3100, 4000]


def _lanes_case(gen, dtype, dqk, dv, G, T, KVH=2, S=4104):
    q, k, v, sk, scale = _prefill_case(gen, dtype, dqk, dv, G, len(LANE_STARTS), T, 0, S, True, KVH=KVH)
    for b, p in enumerate(LANE_STARTS):
        k[b, p + T:] = float("nan")  # past each lane's live rows: never read
        v[b, p + T:] = float("nan")
    positions = torch.tensor(LANE_STARTS, dtype=torch.int32, device="cuda")
    return q, k, v, sk, scale, positions


@pytest.mark.parametrize("dqk,dv", PREFILL_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("T", [5, 8])
def test_prefill_lanes_kernel_matches_plain(gen, dqk, dv, dtype, G, T):
    """The per-lane form: lane b's row i attends [0, starts[b] + i], NaN in
    every lane's dead rows; one launch on `launches_lanes` (none on the
    scalar counters), finite, within tolerance of the plain version over
    per-lane masks, and each lane equal to the scalar form at its start."""
    q, k, v, sk, scale, positions = _lanes_case(gen, dtype, dqk, dv, G, T)
    top = max(LANE_STARTS)
    before = (flash_prefill.launches_lanes, flash_prefill.launches, flash_prefill.launches_mla)
    out = flash_prefill(q, k, v, top, scale=scale, sinks=sk, positions=positions)
    torch.cuda.synchronize()
    after = (flash_prefill.launches_lanes, flash_prefill.launches, flash_prefill.launches_mla)
    assert after == (before[0] + 1, before[1], before[2])
    assert bool(torch.isfinite(out).all())
    want = flash_prefill_plain(q.float(), k.float().nan_to_num(), v.float().nan_to_num(), top, scale=scale,
                               sinks=sk, positions=positions)
    assert (out.float() - want).abs().max().item() <= TOL[dtype]
    for b, p in enumerate(LANE_STARTS):
        one = flash_prefill(q[b : b + 1], k[b : b + 1], v[b : b + 1], p, scale=scale, sinks=sk)
        assert (out[b].float() - one[0].float()).abs().max().item() <= TOL[dtype]


def test_prefill_lanes_form_checks_its_vector(gen):
    """A positions vector of the wrong length, type or device raises before
    any launch."""
    q, k, v, _, _, positions = _lanes_case(gen, torch.float32, 64, 64, 4, 5)
    launches = flash_prefill.launches_lanes
    for bad in (positions[:3], positions.long(), positions.cpu()):
        with pytest.raises(ValueError):
            flash_prefill(q, k, v, 4000, positions=bad)
    assert flash_prefill.launches_lanes == launches


@pytest.mark.parametrize("dqk,dv", PREFILL_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_lanes_call_is_one_device_kernel(gen, traced, dqk, dv, dtype):
    """One per-lane call (B = 8, T = 5) is exactly one device kernel, as
    torch.profiler traces it in a fresh process, and one count on
    launches_lanes."""
    trace = traced[("prefill_lanes", dqk, dv, str(dtype).split(".")[-1])]
    assert trace["counted"] == 1
    kernels = trace["kernels"]
    assert len(kernels) == 1 and "flash_prefill" in kernels[0], kernels


@pytest.mark.parametrize("T,H,pos", [(1100, 32, 37), (600, 64, 0)])
def test_prefill_kernel_wide_tiles(gen, T, H, pos):
    """Calls large enough for 128-row tiles at (64, 64) (prefill_plan; G = 4
    and 8 over 8 KV heads), with sinks and NaN in the dead slots."""
    from dnet_tpu_torch.ops.flash_attention import TC_WIDE_ROWS, prefill_plan

    assert prefill_plan(T, H, 8, 64, 64).block_rows == TC_WIDE_ROWS
    S = pos + T + 40
    q, k, v, sk, _ = _prefill_case(gen, torch.bfloat16, 64, 64, H // 8, 1, T, pos, S, True, KVH=8)
    k[:, pos + T:] = float("nan")
    v[:, pos + T:] = float("nan")
    out = flash_prefill(q, k, v, pos, sinks=sk)
    torch.cuda.synchronize()
    want = flash_prefill_plain(q.float(), k[:, : pos + T].float(), v[:, : pos + T].float(), pos, sinks=sk)
    assert bool(torch.isfinite(out).all())
    assert (out.float() - want).abs().max().item() <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dqk,dv", PREFILL_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_never_reads_dead_slots(gen, dqk, dv, dtype):
    """Cache slots at and past pos + T hold NaN (any bit pattern a dead slot
    may hold): the output is finite and equals the plain version over the
    live prefix, so no dead K or V row meets a zero of P."""
    T, pos, S = 70, 33, 256
    q, k, v, sk, scale = _prefill_case(gen, dtype, dqk, dv, 4, 1, T, pos, S, True)
    k[:, pos + T:] = float("nan")
    v[:, pos + T:] = float("nan")
    out = flash_prefill(q, k, v, pos, scale=scale, sinks=sk)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    want = flash_prefill_plain(q.float(), k[:, : pos + T].float(), v[:, : pos + T].float(), pos,
                               scale=scale, sinks=sk)
    assert (out.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 63, 64, 1024, 4095])
def test_decode_kernel_matches_plain(gen, dtype, pos):
    q = _randn(gen, dtype, 1, 1, 32, 64)
    k, v = _randn(gen, dtype, 1, 4096, 8, 64), _randn(gen, dtype, 1, 4096, 8, 64)
    lengths = decode_lengths(1, pos, "cuda")
    before = flash_decode_attend.launches
    out = flash_decode_attend(q, k, v, lengths, pos + 1)
    torch.cuda.synchronize()
    assert flash_decode_attend.launches == before + 1
    want = flash_decode_plain(q.float(), k.float(), v.float(), lengths)
    assert (out.float() - want).abs().max().item() <= TOL[dtype]


LANE_LENGTHS = [1, 0, 64, 65, 300, 1500, 4095, 4096]


def _quant_cache(gen, bits, B, S=4096):
    """One layer's cache of B lanes, every slot written by the port's
    write_kv from bf16 rows."""
    kvs = layer_slices(init_cache(KVConfig(1, B, S, 8, 64, quant_bits=bits), torch.device("cuda")), 0)
    write_kv(kvs, _randn(gen, torch.bfloat16, B, S, 8, 64), _randn(gen, torch.bfloat16, B, S, 8, 64), 0)
    return kvs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("pos", [0, 63, 64, 1024, 4095])
def test_quantized_decode_kernel_matches_plain(gen, dtype, bits, pos):
    kvs = _quant_cache(gen, bits, 1)
    q = _randn(gen, dtype, 1, 1, 32, 64)
    lengths = decode_lengths(1, pos, "cuda")
    name = f"launches_q{bits}"
    before, plain = getattr(flash_decode_attend, name), flash_decode_attend.launches
    out = flash_decode_attend(q, kvs["k"], kvs["v"], lengths, pos + 1, k_scale=kvs["k_scale"],
                              v_scale=kvs["v_scale"])
    torch.cuda.synchronize()
    assert getattr(flash_decode_attend, name) == before + 1 and flash_decode_attend.launches == plain
    want = flash_decode_plain(q.float(), kvs["k"], kvs["v"], lengths, k_scale=kvs["k_scale"],
                              v_scale=kvs["v_scale"])
    assert out.dtype == dtype and (out.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_decode_kernel_group_8_head_dim_128(gen, dtype, bits):
    """G = 8 over head dim 128 (Llama-3-70B's H = 64, KVH = 8), whose
    instantiations spill registers: ragged lanes with an idle one, the
    normalised output and the LSE partials against their plain versions."""
    B, S = 4, 2048
    if bits:
        kvs = layer_slices(init_cache(KVConfig(1, B, S, 8, 128, quant_bits=bits), torch.device("cuda")), 0)
        write_kv(kvs, _randn(gen, torch.bfloat16, B, S, 8, 128), _randn(gen, torch.bfloat16, B, S, 8, 128), 0)
    else:
        kvs = {"k": _randn(gen, dtype, B, S, 8, 128), "v": _randn(gen, dtype, B, S, 8, 128)}
    scales = {n: kvs[n] for n in ("k_scale", "v_scale") if n in kvs}
    k, v = (kvs[n] if bits else kvs[n].float() for n in ("k", "v"))
    q = _randn(gen, dtype, B, 1, 64, 128)
    lengths = torch.tensor([2048, 0, 1, 700], dtype=torch.int32, device="cuda")
    out = flash_decode_attend(q, kvs["k"], kvs["v"], lengths, 2048, **scales)
    lse = flash_decode_lse(q, kvs["k"], kvs["v"], lengths, 2048, **scales)
    torch.cuda.synchronize()
    want = flash_decode_plain(q.float(), k, v, lengths, **scales)
    assert out.dtype == dtype and (out.float() - want).abs().max().item() <= TOL[dtype]
    assert (out[1] == 0).all()
    _check_lse(lse, flash_decode_lse_plain(q.float(), k, v, lengths, **scales), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_decode_kernel_lengths_vector(gen, bits, dtype):
    """Eight lanes at ragged lengths in one launch, planned for the longest
    (and for a bound above it): each lane as the plain version gives it,
    the idle lane zeros.  An f32 q holds it to 1e-4, where one length off by
    one would show."""
    B = len(LANE_LENGTHS)
    q = _randn(gen, dtype, B, 1, 32, 64)
    if bits:
        kvs = _quant_cache(gen, bits, B)
        scales = {"k_scale": kvs["k_scale"], "v_scale": kvs["v_scale"]}
        k, v = kvs["k"], kvs["v"]
    else:
        k, v = _randn(gen, dtype, B, 4096, 8, 64), _randn(gen, dtype, B, 4096, 8, 64)
        scales = {}
    lengths = torch.tensor(LANE_LENGTHS, dtype=torch.int32, device="cuda")
    want = flash_decode_plain(q.float(), k if bits else k.float(), v if bits else v.float(), lengths, **scales)
    for max_live in (max(LANE_LENGTHS), 4096):
        out = flash_decode_attend(q, k, v, lengths, max_live, **scales)
        torch.cuda.synchronize()
        assert (out.float() - want).abs().max().item() <= TOL[dtype]
        assert not out[1].any()


ROT_W = 128  # gpt-oss-20b's sliding window


def _ring(gen, dtype, bits, B=1, KVH=8, D=64):
    """One layer's ring of ROT_W slots: random values in `dtype`, or codes
    and scales the port's write_kv_rotating quantized from 3 * ROT_W bf16
    rows (the ring keeps the last ROT_W)."""
    if not bits:
        return _randn(gen, dtype, B, ROT_W, KVH, D), _randn(gen, dtype, B, ROT_W, KVH, D), {}
    kvs = layer_slices(init_cache(KVConfig(1, B, ROT_W, KVH, D, quant_bits=bits), torch.device("cuda")), 0)
    rows = 3 * ROT_W
    write_kv_rotating(kvs, _randn(gen, torch.bfloat16, B, rows, KVH, D), _randn(gen, torch.bfloat16, B, rows, KVH, D), 0)
    return kvs["k"], kvs["v"], {"k_scale": kvs["k_scale"], "v_scale": kvs["v_scale"]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("pos,window", [(0, 128), (127, 128), (128, 128), (300, 128), (4095, 128), (300, 91)])
def test_rotating_decode_kernel_matches_plain(gen, dtype, bits, pos, window):
    """gpt-oss-20b's sliding layer (H=64, KVH=8, D=64, sinks) over its ring,
    before, at and past the wrap, the served window and a shorter one;
    counted on the rotating variant's own counter."""
    k, v, scales = _ring(gen, dtype, bits)
    q = _randn(gen, dtype, 1, 1, 64, 64)
    sinks = torch.randn(64, generator=gen, device="cuda")
    lengths = decode_lengths(1, pos, "cuda")
    name = "launches_rot" + (f"_q{bits}" if bits else "")
    before, plain = getattr(flash_decode_attend, name), flash_decode_attend.launches
    out = flash_decode_attend(q, k, v, lengths, min(pos + 1, ROT_W), sinks=sinks, rotating=True, window=window,
                              **scales)
    torch.cuda.synchronize()
    assert getattr(flash_decode_attend, name) == before + 1 and flash_decode_attend.launches == plain
    want = flash_decode_plain(q.float(), k if bits else k.float(), v if bits else v.float(), lengths, sinks=sinks,
                              rotating=True, window=window, **scales)
    assert out.dtype == dtype and (out.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("bits", [0, 8])
def test_rotating_decode_kernel_lanes(gen, bits):
    """Four lanes at their own positions (one idle) in one launch, f32 q."""
    positions = [5, 127, 300, 4095]
    k, v, scales = _ring(gen, torch.float32, bits, B=4)
    q = _randn(gen, torch.float32, 4, 1, 64, 64)
    lengths = torch.tensor([p + 1 for p in positions], dtype=torch.int32, device="cuda")
    lengths[0] = 0
    out = flash_decode_attend(q, k, v, lengths, ROT_W, rotating=True, window=ROT_W, **scales)
    torch.cuda.synchronize()
    want = flash_decode_plain(q, k, v, lengths, rotating=True, window=ROT_W, **scales)
    assert (out - want).abs().max().item() <= TOL[torch.float32] and not out[0].any()


@pytest.mark.parametrize("pos", [0, 63, 1024, 4095])
def test_decode_kernel_bf16_cache_under_f32_q(gen, pos):
    """DNET_KV_BITS=16 on an f32 model: the kernel reads the bf16 cache as it
    is, with the f32 q, counted as the plain variant."""
    q = _randn(gen, torch.float32, 1, 1, 32, 64)
    k, v = _randn(gen, torch.bfloat16, 1, 4096, 8, 64), _randn(gen, torch.bfloat16, 1, 4096, 8, 64)
    lengths = decode_lengths(1, pos, "cuda")
    before = flash_decode_attend.launches
    out = flash_decode_attend(q, k, v, lengths, pos + 1)
    torch.cuda.synchronize()
    assert flash_decode_attend.launches == before + 1
    want = flash_decode_plain(q, k.float(), v.float(), lengths)
    assert out.dtype == torch.float32 and (out - want).abs().max().item() <= TOL[torch.float32]


def test_cuda_tensor_never_takes_the_plain_version(gen):
    """A dtype the kernel does not take raises on the card instead of
    computing through the plain version."""
    q = _randn(gen, torch.float16, 1, 16, 32, 64)
    k = _randn(gen, torch.float16, 1, 64, 8, 64)
    with pytest.raises(ValueError):
        flash_prefill(q, k, k, 0)
    with pytest.raises(ValueError):
        flash_decode_attend(q[:, :1], k, k, decode_lengths(1, 3, "cuda"), 4)
    with pytest.raises(ValueError):  # int64 lengths are not the kernel's
        flash_decode_attend(q[:, :1].float(), k.float(), k.float(), torch.full((1,), 4, device="cuda"), 4)


def _check_lse(out, want, dtype, tol=None):
    """Kernel partials against the plain version's: m within the decode
    tolerance (or `tol`), l within it relative to l, the rank's output
    acc / l within it; an empty rank's partials exactly (0, NEG_INF, 0)."""
    (acc, m, l), (wa, wm, wl) = out, want
    tol = TOL[dtype] if tol is None else tol
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    live = wl > 0
    assert torch.equal(m[~live], wm[~live]) and (l[~live] == 0).all()
    B, KVH, G = m.shape
    assert (acc.reshape(B, KVH, G, -1)[~live] == 0).all()
    if live.any():
        assert (m - wm)[live].abs().max().item() <= tol
        assert ((l - wl)[live] / wl[live]).abs().max().item() <= tol
        norm = lambda a, d: (a.reshape(B, KVH, G, -1) / d.clamp(min=1e-30)[..., None])[live]  # noqa: E731
        assert (norm(acc, l) - norm(wa, wl)).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,kv_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                            (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("pos", [0, 1023, 1024, 2047, 2048, 4095])
def test_lse_kernel_matches_plain_per_rank(gen, dtype, kv_dtype, R, pos):
    """R shards of one 4096-slot cache on one card (ranks wholly past pos
    among them at low positions): each rank's partials against the plain
    version, one launch counted per rank, and the combined ranks against
    the decode kernel over the whole cache."""
    q = _randn(gen, dtype, 1, 1, 32, 64)
    k, v = _randn(gen, kv_dtype, 1, 4096, 8, 64), _randn(gen, kv_dtype, 1, 4096, 8, 64)
    s_local = 4096 // R
    sp = SpGroup(["cuda:0"] * R)
    parts = []
    for r, lengths in enumerate(sp_lengths(1, pos, s_local, sp.devices)):
        kr, vr = k[:, r * s_local : (r + 1) * s_local], v[:, r * s_local : (r + 1) * s_local]
        before = flash_decode_attend.launches_lse
        out = flash_decode_lse(q, kr, vr, lengths, rank_live(pos, r, s_local))
        torch.cuda.synchronize()
        assert flash_decode_attend.launches_lse == before + 1
        _check_lse(out, flash_decode_lse_plain(q.float(), kr.float(), vr.float(), lengths), dtype)
        parts.append(out)
    combined = lse_combine(parts, sp, None, dtype)
    whole = flash_decode_attend(q, k, v, decode_lengths(1, pos, "cuda"), pos + 1)
    assert combined.dtype == dtype and (combined.float() - whole.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [5, 700, 1500])
def test_lse_kernel_head_dim_128_with_sinks(gen, dtype, pos):
    """Head dim 128 (H=32, KVH=8), two ranks of 1024 slots, a lane whose
    length is 0 beside a live one, and sinks folded once by the combine."""
    q = _randn(gen, dtype, 2, 1, 32, 128)
    k, v = _randn(gen, dtype, 2, 2048, 8, 128), _randn(gen, dtype, 2, 2048, 8, 128)
    sinks = torch.randn(32, generator=gen, device="cuda")
    sp = SpGroup(["cuda:0", "cuda:0"])
    parts = []
    for r in range(2):
        kr, vr = k[:, r * 1024 : (r + 1) * 1024].contiguous(), v[:, r * 1024 : (r + 1) * 1024].contiguous()
        live = rank_live(pos, r, 1024)
        lengths = torch.tensor([live, 0], dtype=torch.int32, device="cuda")  # lane 1 idle
        out = flash_decode_lse(q, kr, vr, lengths, live)
        torch.cuda.synchronize()
        _check_lse(out, flash_decode_lse_plain(q.float(), kr.float(), vr.float(), lengths), dtype)
        parts.append(out)
    combined = lse_combine(parts, sp, sinks, dtype)
    whole = flash_decode_attend(q, k, v, torch.tensor([pos + 1, 0], dtype=torch.int32, device="cuda"), pos + 1,
                                sinks=sinks)
    assert (combined.float() - whole.float()).abs().max().item() <= TOL[dtype]


def test_lse_kernel_never_takes_the_plain_version(gen):
    """On the card a head dim, dtype or cache form the LSE form is not
    built for raises instead of computing through the plain version;
    nothing is counted."""
    before = flash_decode_attend.launches_lse
    lengths = decode_lengths(1, 3, "cuda")
    for dt, d in ((torch.float16, 64), (torch.bfloat16, 96)):
        q, k = _randn(gen, dt, 1, 1, 32, d), _randn(gen, dt, 1, 64, 8, d)
        with pytest.raises(ValueError):
            flash_decode_lse(q, k, k, lengths, 4)
    with pytest.raises(ValueError):  # bf16 q over an f32 cache
        flash_decode_lse(_randn(gen, torch.bfloat16, 1, 1, 32, 64), *[_randn(gen, torch.float32, 1, 64, 8, 64)] * 2,
                         lengths, 4)
    assert flash_decode_attend.launches_lse == before


def test_sp_engine_matches_cpu(gen):
    """The sp engine on the card (two ranks on cuda:0: the LSE kernel per
    rank per layer) against the same engine on the CPU, f32: prefill logits
    within 2e-3 across the shard boundary, equal greedy streams, and
    exactly ranks x layers LSE launches per decode step."""
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.parallel.engine import MeshEngine
    from dnet_tpu_torch.utils.random_init import random_llama_params

    cfg = ModelConfig.from_hf({
        "model_type": "llama", "vocab_size": 512, "hidden_size": 256, "intermediate_size": 512,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64,
        "tie_word_embeddings": True,
    })
    window, edge = random_llama_params(cfg, range(2), torch.device("cpu"), torch.float32, seed=1)
    engines = {dev: MeshEngine.from_params(cfg, window, edge, sp=2, max_seq=128, param_dtype="float32",
                                           devices=[dev, dev]) for dev in ("cuda:0", "cpu")}
    prompt = list(range(1, 70))
    logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
    assert (logits["cuda:0"] - logits["cpu"]).abs().max().item() <= 2e-3
    before = flash_decode_attend.launches_lse
    streams = {dev: [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]
               for dev, e in engines.items()}
    torch.cuda.synchronize()
    assert streams["cuda:0"] == streams["cpu"]
    assert flash_decode_attend.launches_lse - before == 2 * 2 * 15


def test_streamed_engine_matches_cpu(gen):
    """A weight-streaming engine on the card (plan (2, 1), sliding_fit:
    each layer copied from page-locked host memory on the cache's copy
    stream, evicted as soon as its kernels are queued) against the same
    engine on the CPU, f32: prefill logits within 2e-3, equal greedy
    streams, one prefill launch a layer per prompt and one decode launch a
    layer per step, and every layer copied again each step."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.utils.random_init import random_llama_params

    cfg = ModelConfig.from_hf({
        "model_type": "llama", "vocab_size": 512, "hidden_size": 256, "intermediate_size": 512,
        "num_hidden_layers": 4, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64,
    })
    window, edge = random_llama_params(cfg, range(4), torch.device("cpu"), torch.float32, seed=1)
    engines = {dev: LocalEngine.from_params(cfg, window, edge, max_seq=128, param_dtype="float32", device=dev,
                                            window_size=2, residency_size=1) for dev in ("cuda", "cpu")}
    assert all(e.plan.name == "sliding_fit" for e in engines.values())
    assert engines["cuda"].weight_cache.store._cache[0].buf.is_pinned()
    prompt = list(range(1, 40))
    logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
    assert (logits["cuda"] - logits["cpu"]).abs().max().item() <= 2e-3
    prefills, decodes = flash_prefill.launches, flash_decode_attend.launches
    loads = engines["cuda"].weight_cache.stats["loads"]
    streams = {dev: [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=12, nonce="g")]
               for dev, e in engines.items()}
    torch.cuda.synchronize()
    assert streams["cuda"] == streams["cpu"]
    assert flash_prefill.launches - prefills == 4
    assert flash_decode_attend.launches - decodes == 4 * 11
    assert engines["cuda"].weight_cache.stats["loads"] - loads == 4 * 12
    for e in engines.values():
        e.close()


@pytest.mark.parametrize("family,bits", [("deepseek_v2", 0), ("deepseek_v2", 8), ("deepseek_v2", 4),
                                         ("gpt_oss", 0), ("gpt_oss", 8)])
def test_sp_engine_families_match_cpu(gen, family, bits):
    """The sp engine on the card against the CPU, f32, small models at the
    kernels' head widths: deepseek_v2 at MLA widths (3 layers, 4 heads),
    exactly ranks x layers launches of the LSE form of the cache's variant
    per decode step; gpt_oss (4 layers, head dim 64, G = 8, window 32)
    launches no kernel (the dense sp attention, as the reference).  Under
    int4 the K/V rows the CPU computes round to other codes than the card's
    now and then (one code is 1/7 of a row's max), so that case is held
    against the single-device engine on the card instead."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.parallel.engine import MeshEngine
    from dnet_tpu_torch.utils import random_init as ri

    if family == "deepseek_v2":
        cfg = ModelConfig.from_hf(dict(
            ri.DEEPSEEK_V2_LITE_CONFIG, vocab_size=512, hidden_size=256, intermediate_size=256,
            moe_intermediate_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
            kv_lora_rank=64, n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2))
        window, edge = ri.random_deepseek_v2_params(cfg, range(3), torch.device("cpu"), torch.float32, seed=4)
    else:
        cfg = ModelConfig.from_hf(dict(
            ri.GPT_OSS_20B_CONFIG, vocab_size=512, hidden_size=256, intermediate_size=128, num_hidden_layers=4,
            num_attention_heads=16, num_key_value_heads=2, head_dim=64, num_local_experts=4,
            num_experts_per_tok=2, sliding_window=32, layer_types=["sliding_attention", "full_attention"] * 2))
        window, edge = ri.random_gpt_oss_params(cfg, range(4), torch.device("cpu"), torch.float32, seed=2)
    kw = dict(max_seq=128, param_dtype="float32", kv_quant_bits=bits)
    ref = "single" if bits == 4 else "cpu"
    engines = {"cuda:0": MeshEngine.from_params(cfg, window, edge, sp=2, devices=["cuda:0"] * 2, **kw),
               ref: (LocalEngine.from_params(cfg, window, edge, device="cuda", **kw) if bits == 4
                     else MeshEngine.from_params(cfg, window, edge, sp=2, devices=["cpu"] * 2, **kw))}
    prompt = [(13 * i) % 500 + 1 for i in range(69)]
    logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
    assert (logits["cuda:0"] - logits[ref]).abs().max().item() <= 2e-3
    torch.cuda.synchronize()
    reset_launch_counts()
    streams = {}
    for dev, e in engines.items():  # the sp engine on the card first: its launches alone
        streams[dev] = [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]
        torch.cuda.synchronize()
        if dev == "cuda:0":
            launches = {k: v for k, v in launch_counts().items() if v}
    assert streams["cuda:0"] == streams[ref]
    want = {}
    if family == "deepseek_v2":
        want = {"flash_decode_lse_mla" + (f"_q{bits}" if bits else ""): 2 * 3 * 15}
    assert launches == want


# DeepSeek-V2-Lite's MLA attention: H = KVH = 16, q/k head dim 192 (nope 128
# + rope 64), v head dim 128, softmax scale 192^-0.5 x mscale(40, 0.707)^2
MLA_H, MLA_DQK, MLA_DV = 16, 192, 128
MLA_SCALE = 192**-0.5 * (0.1 * 0.707 * math.log(40) + 1.0) ** 2


def _mla_cache(gen, dtype, bits, S=4096, B=1):
    """One layer's MLA cache of B lanes: k [B, S, 16, 192], v [B, S, 16,
    128] random in `dtype`, or codes and scales the port's write_kv
    quantized from bf16."""
    if not bits:
        return _randn(gen, dtype, B, S, MLA_H, MLA_DQK), _randn(gen, dtype, B, S, MLA_H, MLA_DV), {}
    cfg = KVConfig(1, B, S, MLA_H, MLA_DQK, v_head_dim=MLA_DV, quant_bits=bits)
    kvs = layer_slices(init_cache(cfg, torch.device("cuda")), 0)
    write_kv(kvs, _randn(gen, torch.bfloat16, B, S, MLA_H, MLA_DQK), _randn(gen, torch.bfloat16, B, S, MLA_H, MLA_DV), 0)
    return kvs["k"], kvs["v"], {"k_scale": kvs["k_scale"], "v_scale": kvs["v_scale"]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,pos,S", [(64, 0, 4096), (100, 37, 512), (17, 200, 300), (512, 0, 4096)])
def test_mla_prefill_kernel_matches_plain(gen, dtype, T, pos, S):
    """Dv != Dqk: the score loop over 192, the output at 128, counted on the
    MLA counter only."""
    q = _randn(gen, dtype, 1, T, MLA_H, MLA_DQK)
    k, v, _ = _mla_cache(gen, dtype, 0, S)
    before, plain = flash_prefill.launches_mla, flash_prefill.launches
    out = flash_prefill(q, k, v, pos, scale=MLA_SCALE)
    torch.cuda.synchronize()
    assert flash_prefill.launches_mla == before + 1 and flash_prefill.launches == plain
    want = flash_prefill_plain(q.float(), k.float(), v.float(), pos, scale=MLA_SCALE)
    assert out.shape == (1, T, MLA_H, MLA_DV) and out.dtype == dtype
    assert (out.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("pos", [0, 63, 64, 300, 4095])
def test_mla_decode_kernel_matches_plain(gen, dtype, bits, pos):
    """G = 1 over a plain, q8 or q4 cache (K packs 96 bytes a row under
    int4, V 64), each form on its own MLA counter."""
    k, v, scales = _mla_cache(gen, dtype, bits)
    q = _randn(gen, dtype, 1, 1, MLA_H, MLA_DQK)
    lengths = decode_lengths(1, pos, "cuda")
    name = "launches_mla" + (f"_q{bits}" if bits else "")
    before, plain = getattr(flash_decode_attend, name), flash_decode_attend.launches
    out = flash_decode_attend(q, k, v, lengths, pos + 1, scale=MLA_SCALE, **scales)
    torch.cuda.synchronize()
    assert getattr(flash_decode_attend, name) == before + 1 and flash_decode_attend.launches == plain
    want = flash_decode_plain(q.float(), k if bits else k.float(), v if bits else v.float(), lengths,
                              scale=MLA_SCALE, **scales)
    assert out.shape == (1, 1, MLA_H, MLA_DV) and out.dtype == dtype
    assert (out.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("pos", [0, 300, 4095])
def test_mla_decode_bf16_cache_under_f32_q(gen, pos):
    """DNET_KV_BITS=16 on an f32 deepseek_v2: the bf16 MLA cache read as it
    is under an f32 q."""
    q = _randn(gen, torch.float32, 1, 1, MLA_H, MLA_DQK)
    k, v, _ = _mla_cache(gen, torch.bfloat16, 0)
    lengths = decode_lengths(1, pos, "cuda")
    out = flash_decode_attend(q, k, v, lengths, pos + 1, scale=MLA_SCALE)
    torch.cuda.synchronize()
    want = flash_decode_plain(q, k.float(), v.float(), lengths, scale=MLA_SCALE)
    assert out.dtype == torch.float32 and (out - want).abs().max().item() <= TOL[torch.float32]


# the LSE form's cache forms beyond the plain (64, 64) / (128, 128) ones:
# (name, counter, q/k head dim, v head dim, H, KVH, qbits, cache dtype under q)
LSE_FORMS = [
    ("mla", "launches_lse_mla", MLA_DQK, MLA_DV, MLA_H, MLA_H, 0, None),
    ("mla_bf16_cache", "launches_lse_mla", MLA_DQK, MLA_DV, MLA_H, MLA_H, 0, torch.bfloat16),
    ("q8", "launches_lse_q8", 64, 64, 32, 8, 8, None),
    ("q4", "launches_lse_q4", 64, 64, 32, 8, 4, None),
    ("mla_q8", "launches_lse_mla_q8", MLA_DQK, MLA_DV, MLA_H, MLA_H, 8, None),
    ("mla_q4", "launches_lse_mla_q4", MLA_DQK, MLA_DV, MLA_H, MLA_H, 4, None),
]


# each form under an f32 and a bf16 q, but the bf16 cache under an f32 q only
LSE_CASES = [(f, dt) for f in LSE_FORMS for dt in (torch.float32, torch.bfloat16) if f[7] is None or dt == torch.float32]


@pytest.mark.parametrize("form,dtype", LSE_CASES, ids=[f"{f[0]}-{str(dt)[6:]}" for f, dt in LSE_CASES])
@pytest.mark.parametrize("pos", [0, 2047, 2048, 4095])
def test_lse_kernel_mla_and_code_forms_match_plain(gen, form, dtype, pos):
    """The LSE form at MLA widths (G = 1, DeepSeek-V2-Lite's scale; also a
    bf16 cache under an f32 q) and over q8 / q4 codes at (64, 64) and
    (192, 128) that the port's write_kv quantized: two ranks of 2048 slots
    of one cache (rank 1 empty at pos 0 and 2047: exactly (0, NEG_INF, 0)),
    each rank's partials against the plain version on its own counter, and
    the combined ranks against the decode kernel over the whole cache."""
    _, counter, dqk, dv, H, KVH, bits, cache_dtype = form
    scale = MLA_SCALE if dqk == MLA_DQK else None
    S = 4096
    if bits:
        kvs = layer_slices(init_cache(KVConfig(1, 1, S, KVH, dqk, v_head_dim=dv, quant_bits=bits),
                                      torch.device("cuda")), 0)
        write_kv(kvs, _randn(gen, torch.bfloat16, 1, S, KVH, dqk), _randn(gen, torch.bfloat16, 1, S, KVH, dv), 0)
    else:
        kv_dtype = cache_dtype or dtype
        kvs = {"k": _randn(gen, kv_dtype, 1, S, KVH, dqk), "v": _randn(gen, kv_dtype, 1, S, KVH, dv)}
    q = _randn(gen, dtype, 1, 1, H, dqk)
    sp = SpGroup(["cuda:0", "cuda:0"])
    parts = []
    for r, lengths in enumerate(sp_lengths(1, pos, S // 2, sp.devices)):
        shard = {n: t[:, r * (S // 2) : (r + 1) * (S // 2)] for n, t in kvs.items()}
        scales = {n: shard[n] for n in ("k_scale", "v_scale") if n in shard}
        before = {c: getattr(flash_decode_attend, c) for c in ("launches_lse", counter)}
        out = flash_decode_lse(q, shard["k"], shard["v"], lengths, rank_live(pos, r, S // 2), scale=scale, **scales)
        torch.cuda.synchronize()
        assert getattr(flash_decode_attend, counter) == before[counter] + 1
        assert counter == "launches_lse" or flash_decode_attend.launches_lse == before["launches_lse"]
        assert out[0].shape == (1, 1, H, dv)
        want = flash_decode_lse_plain(q.float(), shard["k"] if bits else shard["k"].float(),
                                      shard["v"] if bits else shard["v"].float(), lengths, scale=scale, **scales)
        _check_lse(out, want, dtype)
        parts.append(out)
    combined = lse_combine(parts, sp, None, dtype)
    whole = flash_decode_attend(q, kvs["k"], kvs["v"], decode_lengths(1, pos, "cuda"), pos + 1, scale=scale,
                                **{n: kvs[n] for n in ("k_scale", "v_scale") if n in kvs})
    assert combined.shape == (1, 1, H, dv) and (combined.float() - whole.float()).abs().max().item() <= TOL[dtype]


def test_mla_widths_never_take_the_plain_version(gen):
    """On the card a (Dqk, Dv) pair the kernels are not built for, and the
    rotating variant at MLA widths, raise instead of computing through the
    plain versions; nothing is counted."""
    q = _randn(gen, torch.bfloat16, 1, 16, MLA_H, 96)
    k, v = _randn(gen, torch.bfloat16, 1, 64, MLA_H, 96), _randn(gen, torch.bfloat16, 1, 64, MLA_H, 64)
    counts = (flash_prefill.launches_mla, flash_decode_attend.launches_mla)
    with pytest.raises(ValueError):
        flash_prefill(q, k, v, 0)
    with pytest.raises(ValueError):
        flash_decode_attend(q[:, :1], k, v, decode_lengths(1, 3, "cuda"), 4)
    k, v, _ = _mla_cache(gen, torch.bfloat16, 0, S=128)
    with pytest.raises(ValueError):
        flash_decode_attend(_randn(gen, torch.bfloat16, 1, 1, MLA_H, MLA_DQK), k, v, decode_lengths(1, 3, "cuda"),
                            4, rotating=True, window=128)
    assert (flash_prefill.launches_mla, flash_decode_attend.launches_mla) == counts


# one call of every decode form: (counter, q/k head dim, v head dim, H, KVH,
# qbits, rotating, LSE), at Llama-3.2-1B's, gpt-oss-20b's sliding and
# DeepSeek-V2-Lite's widths
DECODE_FORMS = [
    ("launches", 64, 64, 32, 8, 0, False, False), ("launches_q8", 64, 64, 32, 8, 8, False, False),
    ("launches_q4", 64, 64, 32, 8, 4, False, False), ("launches_rot", 64, 64, 64, 8, 0, True, False),
    ("launches_rot_q8", 64, 64, 64, 8, 8, True, False), ("launches_rot_q4", 64, 64, 64, 8, 4, True, False),
    ("launches_mla", MLA_DQK, MLA_DV, MLA_H, MLA_H, 0, False, False),
    ("launches_mla_q8", MLA_DQK, MLA_DV, MLA_H, MLA_H, 8, False, False),
    ("launches_mla_q4", MLA_DQK, MLA_DV, MLA_H, MLA_H, 4, False, False),
    ("launches_lse", 64, 64, 32, 8, 0, False, True), ("launches_lse_q8", 64, 64, 32, 8, 8, False, True),
    ("launches_lse_q4", 64, 64, 32, 8, 4, False, True),
    ("launches_lse_mla", MLA_DQK, MLA_DV, MLA_H, MLA_H, 0, False, True),
    ("launches_lse_mla_q8", MLA_DQK, MLA_DV, MLA_H, MLA_H, 8, False, True),
    ("launches_lse_mla_q4", MLA_DQK, MLA_DV, MLA_H, MLA_H, 4, False, True),
]


def _decode_form_call(gen, form, dtype=torch.bfloat16, lengths=(2048,), S=2048):
    """A zero-argument call of one decode form over a fresh cache (codes the
    port's write_kv quantized from bf16 rows; a ring of 128 slots when
    rotating), and its plain version's output computed in f32."""
    _, dqk, dv, H, KVH, bits, rot, lse = form
    B = len(lengths)
    S = 128 if rot else S
    if bits:
        kvs = layer_slices(init_cache(KVConfig(1, B, S, KVH, dqk, v_head_dim=dv, quant_bits=bits),
                                      torch.device("cuda")), 0)
        write_kv(kvs, _randn(gen, torch.bfloat16, B, S, KVH, dqk), _randn(gen, torch.bfloat16, B, S, KVH, dv), 0)
        k, v, scales = kvs["k"], kvs["v"], {"k_scale": kvs["k_scale"], "v_scale": kvs["v_scale"]}
    else:
        k, v, scales = _randn(gen, dtype, B, S, KVH, dqk), _randn(gen, dtype, B, S, KVH, dv), {}
    q = _randn(gen, dtype, B, 1, H, dqk)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    max_live = min(max(lengths), S)
    scale = MLA_SCALE if dqk == MLA_DQK else None
    kf, vf = (k, v) if bits else (k.float(), v.float())
    if lse:
        return (lambda: flash_decode_lse(q, k, v, lens, max_live, scale=scale, **scales),
                flash_decode_lse_plain(q.float(), kf, vf, lens, scale=scale, **scales))
    extra = {"rotating": True, "window": S, "sinks": torch.randn(H, generator=gen, device="cuda")} if rot else {}
    return (lambda: flash_decode_attend(q, k, v, lens, max_live, scale=scale, **scales, **extra),
            flash_decode_plain(q.float(), kf, vf, lens, scale=scale, **scales, **extra))


def _check_form(out, want, form, dtype):
    if form[7]:
        _check_lse(out, want, dtype)
    else:
        assert (out.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("form", DECODE_FORMS, ids=[f[0] for f in DECODE_FORMS])
def test_decode_wrapper_call_is_one_device_kernel(gen, traced, form):
    """Every decode form, normalised and LSE, runs as exactly one device
    kernel per wrapper call (the splits merge inside it), as torch.profiler
    traces it in a fresh process (tests/torch_gpu_trace.py), counted once on
    its own counter."""
    call, want = _decode_form_call(gen, form)
    out = call()
    trace = traced[("decode", "decode", DECODE_FORMS.index(form))]
    assert trace["counted"] == 1
    kernels = trace["kernels"]
    assert len(kernels) == 1 and "flash_decode_kernel" in kernels[0], kernels
    _check_form(out, want, form, torch.bfloat16)


@pytest.mark.parametrize("dqk,dv", PREFILL_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_wrapper_call_is_one_device_kernel(gen, traced, dqk, dv, dtype):
    """One prefill call is exactly one device kernel, as torch.profiler
    traces it in a fresh process, and one count on its counter."""
    trace = traced[("prefill", dqk, dv, str(dtype).split(".")[-1])]
    assert trace["counted"] == 1
    kernels = trace["kernels"]
    assert len(kernels) == 1 and "flash_prefill" in kernels[0], kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_split", [None, 16])
def test_paged_wrapper_call_is_one_device_kernel(gen, traced, dtype, n_split):
    """One paged call is exactly one device kernel at the plan's split count
    and at the cap (the splits merge inside it), as torch.profiler traces
    it in a fresh process, and one count on its counter."""
    trace = traced[("paged", str(dtype).split(".")[-1], n_split)]
    assert trace["counted"] == 1
    kernels = trace["kernels"]
    assert len(kernels) == 1 and "paged_attention_kernel" in kernels[0], kernels


@pytest.mark.parametrize("R", [1, 1500])
def test_column_topk_call_is_one_device_kernel(gen, traced, R):
    """A column_topk call is exactly one device kernel at the decode hop's
    and at a prompt frame's rows, as torch.profiler traces it in a fresh
    process."""
    kernels = traced[("column_topk", R)]["kernels"]
    assert len(kernels) == 1 and "norms_topk_kernel" in kernels[0], kernels


@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits", [8, 4])
def test_weight_quantizer_on_the_card_equals_the_cpu(gen, bits, scale_dtype):
    """A Llama-3.3-70B MLP weight ([8192, 28672] bf16) quantized on the card
    at the bits' default group: codes, scales and the dequantized weight
    equal the CPU's bit for bit (the CPU's equal dnet_tpu's,
    tests/test_torch_weight_quant.py)."""
    from dnet_tpu_torch.ops.quant import dq, quantize_weight_q4, quantize_weight_q8

    quantize = quantize_weight_q4 if bits == 4 else quantize_weight_q8
    w = (torch.randn(8192, 28672, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    got = quantize(w, scale_dtype=scale_dtype)
    want = quantize(w.cpu(), scale_dtype=scale_dtype)
    assert sorted(got) == sorted(want) and got["s"].dtype == scale_dtype
    assert all(torch.equal(got[k].cpu(), want[k]) for k in want)
    assert torch.equal(dq(got).cpu(), dq(want))


def test_trace_helper_traces_a_known_kernel(gen, traced):
    """The tracing process itself: one in-place add on the card is one
    elementwise device kernel, among the session's other (host) events."""
    trace = traced[("add",)]
    assert trace["events"] > len(trace["kernels"]) == 1, trace
    assert "elementwise" in trace["kernels"][0], trace


def _trace_decode(gen, mp, forms: str, i: int):
    form = (DECODE_FORMS if forms == "decode" else WIDE_FORMS)[i]
    call, _ = _decode_form_call(gen, form)
    return call, (lambda: getattr(flash_decode_attend, form[0])) if forms == "decode" else None


def _trace_prefill(gen, mp, dqk: int, dv: int, dtype: str):
    q, k, v, _, scale = _prefill_case(gen, getattr(torch, dtype), dqk, dv, 4, 1, 200, 60, 512, False)
    attr = "launches" if dqk == dv else "launches_mla"
    return (lambda: flash_prefill(q, k, v, 60, scale=scale)), (lambda: getattr(flash_prefill, attr))


def _trace_prefill_lanes(gen, mp, dqk: int, dv: int, dtype: str):
    q, k, v, sk, scale, positions = _lanes_case(gen, getattr(torch, dtype), dqk, dv, 4, 5)
    return ((lambda: flash_prefill(q, k, v, max(LANE_STARTS), scale=scale, sinks=sk, positions=positions)),
            (lambda: flash_prefill.launches_lanes))


def _trace_paged(gen, mp, dtype: str, n_split, wide: bool = False):
    shape = dict(H=64, KVH=4, D=128) if wide else {}
    case = _paged_case(gen, getattr(torch, dtype), 16, [57, 92, 182, 332, 552, 832, 1132, 1532], **shape)
    if n_split is not None:
        _paged_blocks_per_slot(mp, n_split)
    attr = "launches_wide" if wide else "launches"  # G = 16 counts on the wide counter
    return (lambda: paged_attend(*case, max_live=1532)), (lambda: getattr(paged_attend, attr))


def _trace_column_topk(gen, mp, R: int):
    x = _randn(gen, torch.bfloat16, R, 2048)
    return (lambda: column_topk(x, 1024)), None


def _trace_add(gen, mp):
    x = torch.zeros(1 << 20, device="cuda")
    return (lambda: x.add_(1.0)), None


# the one-kernel-a-call cases, by name: each builds (a zero-argument call,
# its counter or None) from the seeded generator as its test makes its
# inputs; tests/torch_gpu_trace.py traces them in a fresh process
TRACE_CASES = {"decode": _trace_decode, "prefill": _trace_prefill, "prefill_lanes": _trace_prefill_lanes,
               "paged": _trace_paged, "column_topk": _trace_column_topk, "add": _trace_add}


def test_decode_interleaved_shapes_repeat_exactly(gen):
    """Calls of different forms, widths, lengths and split counts
    interleaved on one stream, three rounds: every round's outputs are
    bit-identical to the first's, so no merge state carries from one call
    to the next."""
    picks = [DECODE_FORMS[0], DECODE_FORMS[12], DECODE_FORMS[3], DECODE_FORMS[9], DECODE_FORMS[7]]
    calls = [_decode_form_call(gen, f, lengths=lengths)
             for f in picks for lengths in ((2048,), (5, 0, 1999))]
    rounds = []
    for _ in range(3):
        rounds.append([c() for c, _ in calls])
    torch.cuda.synchronize()
    flat = lambda r: [t for x in r for t in (x if isinstance(x, tuple) else (x,))]  # noqa: E731
    for r in rounds[1:]:
        assert all(torch.equal(a, b) for a, b in zip(flat(rounds[0]), flat(r)))


@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 7, "cap"])
@pytest.mark.parametrize("form", [DECODE_FORMS[0], DECODE_FORMS[9], DECODE_FORMS[12], DECODE_FORMS[14]],
                         ids=["plain", "lse", "lse_mla", "lse_mla_q4"])
def test_decode_split_counts_up_to_the_cap(gen, monkeypatch, form, n_split):
    """The kernel at every split count up to the plan's cap (which a
    2048-slot lane at 8 KV heads reaches), over lanes of mixed length and an
    idle one: each lane as the plain version gives it, the last block of
    each (lane, KV head) merging the others' states."""
    from dnet_tpu_torch.ops import flash_decode as fd

    if n_split == "cap":
        assert fd.decode_plan(2048, 8) == fd.MAX_SPLITS
        n_split = fd.MAX_SPLITS
    monkeypatch.setattr(fd, "decode_plan", lambda max_live, blocks: n_split)
    call, want = _decode_form_call(gen, form, dtype=torch.float32, lengths=(2048, 0, 1, 700))
    out = call()
    torch.cuda.synchronize()
    _check_form(out, want, form, torch.float32)


@pytest.mark.parametrize("form", [f for f in DECODE_FORMS if not f[6]], ids=[f[0] for f in DECODE_FORMS if not f[6]])
def test_decode_batched_lanes_with_idle_ones(gen, form):
    """Six lanes in one launch, two of them idle, in every non-rotating form
    (the rotating forms' lanes: test_rotating_decode_kernel_lanes): an idle
    lane gives zeros, or (0, NEG_INF, 0) partials."""
    call, want = _decode_form_call(gen, form, lengths=(0, 3, 64, 0, 1500, 2048))
    out = call()
    torch.cuda.synchronize()
    _check_form(out, want, form, torch.bfloat16)
    if not form[7]:
        assert not out[0].any() and not out[3].any()


PAGED_POSITIONS = [0, 15, 16, 100, 1023, 2047, 4000, 4094]


def _paged_case(gen, dtype, bt, positions=PAGED_POSITIONS, cap=4096, H=32, KVH=8, D=64):
    """A pool holding every slot's live blocks in shuffled order, plus one
    NaN block that every dead table entry points at: a kernel that read a
    dead entry would put NaN into its output."""
    B = len(positions)
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
        _randn(gen, dtype, B, 1, H, D), k_pool, v_pool, tables.cuda(),
        torch.tensor(positions, dtype=torch.int32, device="cuda"),
        _randn(gen, dtype, B, KVH, D), _randn(gen, dtype, B, KVH, D),
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt", [8, 16, 64, 128])
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


@pytest.mark.parametrize("bt", [8, 64])
def test_paged_kernel_bf16_pool_under_f32_q(gen, bt):
    """DNET_KV_BITS=16 on an f32 model: a bf16 pool under an f32 q, the new
    rows in f32 (attended unrounded)."""
    q, k_pool, v_pool, tables, pos, k_new, v_new = _paged_case(gen, torch.float32, bt)
    k_pool, v_pool = k_pool.to(torch.bfloat16), v_pool.to(torch.bfloat16)
    case = (q, k_pool, v_pool, tables, pos, k_new, v_new)
    want = paged_attend_plain(q, k_pool.float(), v_pool.float(), tables, pos, k_new, v_new)
    out = paged_attend(*case, max_live=max(PAGED_POSITIONS))
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and (out - want).abs().max().item() <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,KVH", [(8, 8), (32, 8), (24, 8), (64, 8)])
def test_paged_kernel_groups_and_head_dims(gen, dtype, D, H, KVH):
    """G = 1, 4, 3 (held as 4 query rows) and 8 query heads per KV head at
    head dims 64 and 128, over ragged slots with NaN behind every dead
    entry."""
    case = _paged_case(gen, dtype, 16, [0, 1, 77, 1530, 4000], H=H, KVH=KVH, D=D)
    want = paged_attend_plain(*(t.float() if t.is_floating_point() else t for t in case))
    out = paged_attend(*case, max_live=4000)
    torch.cuda.synchronize()
    assert (out.float() - want).abs().max().item() <= TOL[dtype]
    assert torch.equal(out[0, 0], case[6][0].repeat_interleave(H // KVH, dim=0))  # pos 0: exactly v_new


def _paged_blocks_per_slot(monkeypatch, n):
    """Plan every paged call at n blocks a slot (a KV head's budget n x
    slots)."""
    from dnet_tpu_torch.ops import paged_attention

    monkeypatch.setattr(paged_attention, "paged_plan", lambda max_live, slots, kv_heads, per_sm=1: n * slots)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_split", range(1, 17))
def test_paged_split_counts_up_to_the_cap(gen, monkeypatch, dtype, n_split):
    """Every budget up to the cap's 16 blocks a slot over ragged slots (an
    empty one, one shorter than its share of blocks, the longest near
    capacity): each slot's blocks split its own tiles, the last to finish
    merging them."""
    from dnet_tpu_torch.ops.flash_decode import MAX_SPLITS

    assert MAX_SPLITS == 16
    case = _paged_case(gen, dtype, 16, [0, 65, 700, 4094])
    want = paged_attend_plain(*(t.float() if t.is_floating_point() else t for t in case))
    _paged_blocks_per_slot(monkeypatch, n_split)
    out = paged_attend(*case)
    torch.cuda.synchronize()
    assert (out.float() - want).abs().max().item() <= TOL[dtype]


def test_paged_interleaved_calls_repeat_exactly(gen, monkeypatch):
    """Paged calls of other shapes, dtypes and budgets, interleaved with
    decode calls on one stream, three rounds: every round's outputs are
    bit-identical to the first's, so every ticket is back at 0 after each
    call."""
    from dnet_tpu_torch.ops import paged_attention

    plan = paged_attention.paged_plan
    cases = [(_paged_case(gen, torch.bfloat16, 16, [57, 1530, 0, 300]), 4),
             (_paged_case(gen, torch.float32, 8, [4000, 3], H=8, KVH=8, D=128), 16),
             (_paged_case(gen, torch.bfloat16, 64, [2047, 2048, 100]), None)]
    decode, _ = _decode_form_call(gen, DECODE_FORMS[0], lengths=(2048,))
    rounds = []
    for _ in range(3):
        outs = []
        for case, n in cases:
            if n is None:
                monkeypatch.setattr(paged_attention, "paged_plan", plan)
            else:
                _paged_blocks_per_slot(monkeypatch, n)
            outs.append(paged_attend(*case))
            outs.append(decode())
        rounds.append(outs)
    torch.cuda.synchronize()
    for r in rounds[1:]:
        assert all(torch.equal(a, b) for a, b in zip(rounds[0], r))


# wider groups than a block's 8 query rows (row groups of blocks): G = 9,
# 12, 16 (Qwen3-235B-A22B's 64 / 4 heads) and 32, over 2 KV heads
WIDE_GROUPS = [9, 12, 16, 32]
WIDE_LENGTHS = (2048, 0, 1, 700)


def _wide_form(G, D, bits, lse):
    """A DECODE_FORMS entry at group G and head dim D on 2 KV heads, counted
    on the wide counter."""
    return ("launches_wide", D, D, 2 * G, 2, bits, False, lse)


@pytest.mark.parametrize("G", WIDE_GROUPS)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("lse", [False, True], ids=["normalised", "lse"])
def test_decode_kernel_wide_groups(gen, G, D, bits, lse):
    """More query heads a KV head than a block holds, in the plain, q8, q4
    and LSE forms at head dims 64 and 128, over ragged lanes with an idle
    one: each head as the plain version gives it (the last row group's
    masked rows never written), one launch on launches_wide and none on
    the form's own counter."""
    form = _wide_form(G, D, bits, lse)
    narrow = {c: getattr(flash_decode_attend, c) for c in ("launches", "launches_q8", "launches_q4",
                                                             "launches_lse", "launches_lse_q8", "launches_lse_q4")}
    call, want = _decode_form_call(gen, form, dtype=torch.float32, lengths=WIDE_LENGTHS)
    before = flash_decode_attend.launches_wide
    out = call()
    torch.cuda.synchronize()
    assert flash_decode_attend.launches_wide == before + 1
    assert {c: getattr(flash_decode_attend, c) for c in narrow} == narrow
    _check_form(out, want, form, torch.float32)


@pytest.mark.parametrize("G", [12, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_wide_groups_rotating_and_sinks(gen, G, dtype):
    """The rotating ring with sinks at G > 8 (every form takes the row-group
    split): each head's sink folds once, into its own row."""
    form = ("launches_wide", 64, 64, 2 * G, 2, 0, True, False)
    call, want = _decode_form_call(gen, form, dtype=dtype, lengths=(300, 5, 0))
    out = call()
    torch.cuda.synchronize()
    _check_form(out, want, form, dtype)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, "cap"])
@pytest.mark.parametrize("lse", [False, True], ids=["normalised", "lse"])
@pytest.mark.parametrize("bits", [0, 4])
def test_decode_wide_split_counts_up_to_the_cap(gen, monkeypatch, n_split, lse, bits):
    """G = 16 at head dim 128 at every split count up to the cap: each
    (lane, KV head, row group) merges its own blocks' states (a merge keyed
    by (lane, KV head) alone would fire after half of them or mix two
    groups' rows)."""
    from dnet_tpu_torch.ops import flash_decode as fd

    if n_split == "cap":
        n_split = fd.MAX_SPLITS
    monkeypatch.setattr(fd, "decode_plan", lambda max_live, blocks: n_split)
    form = _wide_form(16, 128, bits, lse)
    call, want = _decode_form_call(gen, form, dtype=torch.float32, lengths=WIDE_LENGTHS)
    out = call()
    torch.cuda.synchronize()
    _check_form(out, want, form, torch.float32)


def test_decode_plan_counts_row_groups():
    """A G = 16 call over 4 KV heads plans for its (KV head, row group)
    pairs a lane: on the CUDA cores four row groups of 4 (16 pairs: as
    many blocks as G = 4 over 16 KV heads), on the tensor cores one of 16
    (4 pairs); one wave either way."""
    from dnet_tpu_torch.ops import flash_decode as fd

    assert fd.decode_layout(torch.float32, torch.float32, 0, 128, 128, 16) == (False, 4, 4)
    assert fd.decode_layout(torch.bfloat16, torch.bfloat16, 0, 128, 128, 16) == (True, 16, 1)
    for rg in (4, 1):
        n = fd.decode_plan(2048, 4 * rg)
        assert n == fd.decode_plan(2048, 4 * rg) and n * 4 * rg <= fd.DECODE_BLOCKS


@pytest.mark.parametrize("rows,dtype", [(16, torch.bfloat16), (4, torch.bfloat16), (4, torch.float32)])
@pytest.mark.parametrize("lse", [False, True], ids=["normalised", "lse"])
def test_decode_group_8_head_dim_128_both_layouts(gen, monkeypatch, rows, dtype, lse):
    """G = 8 at head dim 128 in bf16 as one block of 16 rows on the tensor
    cores (the launcher's) and as two row groups of 4 on the CUDA cores
    (forced), f32 as two of 4: each as the plain version gives it, on the
    narrow counter, the tensor-core form once more on launches_mma."""
    from dnet_tpu_torch.ops import flash_decode as fd

    if rows == 4:
        monkeypatch.setattr(fd, "takes_mma", lambda *a, **k: False)
    assert fd.decode_layout(dtype, dtype, 0, 128, 128, 8)[1] == rows
    form = ("launches_lse" if lse else "launches", 128, 128, 64, 8, 0, False, lse)
    call, want = _decode_form_call(gen, form, dtype=dtype, lengths=WIDE_LENGTHS)
    counters = (form[0], "launches_wide", "launches_mma")
    before = [getattr(flash_decode_attend, c) for c in counters]
    out = call()
    torch.cuda.synchronize()
    assert [getattr(flash_decode_attend, c) for c in counters] == [before[0] + 1, before[1], before[2] + (rows == 16)]
    _check_form(out, want, form, dtype)


# the tensor-core forms: a bf16 q over a bf16 cache at head dim 128 with
# G >= 5 (Qwen2.5-7B's 7, Qwen3-30B-A3B's 8, Qwen3-235B-A22B's 16; 24 runs
# as two row groups of 16, the second half masked), lanes at every tile
# edge of a 4096-slot cache
MMA_GROUPS = [5, 7, 8, 12, 16, 24]
MMA_LENGTHS = tuple(p + 1 for p in (0, 1, 63, 64, 65, 113, 2047, 4095))


def _mma_form(G, lse):
    """A DECODE_FORMS entry of the tensor-core form at group G on 2 KV
    heads, on the counter its group counts on (wide past 8)."""
    counter = "launches_wide" if G > 8 else "launches_lse" if lse else "launches"
    return (counter, 128, 128, 2 * G, 2, 0, False, lse)


def _check_mma(out, want, lse):
    """The tensor-core forms' tolerances (MMA_TOL, which
    tests/test_torch_decode_mma.py states): f32 partials, bf16 outputs."""
    if lse:
        _check_lse(out, want, torch.bfloat16, tol=MMA_TOL[torch.float32])
    else:
        assert (out.float() - want).abs().max().item() <= MMA_TOL[torch.bfloat16]


@pytest.mark.parametrize("G", MMA_GROUPS)
@pytest.mark.parametrize("lse", [False, True], ids=["normalised", "lse"])
@pytest.mark.parametrize("lanes", [1, 8])
def test_decode_mma_forms(gen, G, lse, lanes):
    """Each lane length alone (lanes 1) and all eight in one launch (lanes
    8): the plain version's outputs within MMA_TOL, one count on the
    group's counter and one on launches_mma."""
    form = _mma_form(G, lse)
    for lengths in ([(n,) for n in MMA_LENGTHS] if lanes == 1 else [MMA_LENGTHS]):
        call, want = _decode_form_call(gen, form, lengths=lengths, S=4096)
        before = getattr(flash_decode_attend, form[0]), flash_decode_attend.launches_mma
        out = call()
        torch.cuda.synchronize()
        assert (getattr(flash_decode_attend, form[0]), flash_decode_attend.launches_mma) == (before[0] + 1,
                                                                                           before[1] + 1)
        _check_mma(out, want, lse)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, "cap"])
@pytest.mark.parametrize("lse", [False, True], ids=["normalised", "lse"])
@pytest.mark.parametrize("G", [8, 24])
def test_decode_mma_split_counts_up_to_the_cap(gen, monkeypatch, n_split, lse, G):
    """The tensor-core form at every split count up to the cap, over lanes
    with an idle one: each (lane, KV head, row group of 16) merges its own
    blocks."""
    from dnet_tpu_torch.ops import flash_decode as fd

    monkeypatch.setattr(fd, "decode_plan", lambda max_live, blocks: fd.MAX_SPLITS if n_split == "cap" else n_split)
    call, want = _decode_form_call(gen, _mma_form(G, lse), lengths=WIDE_LENGTHS)
    out = call()
    torch.cuda.synchronize()
    _check_mma(out, want, lse)
    if not lse:
        assert not out[1].any()


def test_decode_mma_sinks(gen):
    """The normalised tensor-core form folds each head's sink once."""
    q, k, v = _randn(gen, torch.bfloat16, 2, 1, 32, 128), *(_randn(gen, torch.bfloat16, 2, 512, 4, 128)
                                                             for _ in range(2))
    sinks = torch.randn(32, generator=gen, device="cuda")
    lens = torch.tensor([300, 1], dtype=torch.int32, device="cuda")
    out = flash_decode_attend(q, k, v, lens, 300, sinks=sinks)
    torch.cuda.synchronize()
    want = flash_decode_plain(q.float(), k.float(), v.float(), lens, sinks=sinks)
    assert (out.float() - want).abs().max().item() <= MMA_TOL[torch.bfloat16]


@pytest.mark.parametrize("G", [7, 8, 16, 24])
@pytest.mark.parametrize("bt", [16, 64])
def test_paged_mma_form(gen, G, bt):
    """The paged kernel's tensor-core form over ragged slots with NaN
    behind every dead entry: within MMA_TOL[bf16] of the plain version,
    pos 0 exactly v_new, one count on launches_mma."""
    case = _paged_case(gen, torch.bfloat16, bt, [0, 1, 77, 1530, 4000], H=2 * G, KVH=2, D=128)
    want = paged_attend_plain(*(t.float() if t.is_floating_point() else t for t in case))
    before = paged_attend.launches_mma
    out = paged_attend(*case, max_live=4000)
    torch.cuda.synchronize()
    assert paged_attend.launches_mma == before + 1
    assert (out.float() - want).abs().max().item() <= MMA_TOL[torch.bfloat16]
    assert torch.equal(out[0, 0], case[6][0].repeat_interleave(G, dim=0))


@pytest.mark.parametrize("n_split", [1, 2, 5, 16])
def test_paged_mma_split_counts(gen, monkeypatch, n_split):
    """G = 16 in bf16 at budgets up to the cap: each (slot, KV head) merges
    its own blocks with the new row."""
    case = _paged_case(gen, torch.bfloat16, 16, [0, 65, 700, 4094], H=64, KVH=4, D=128)
    want = paged_attend_plain(*(t.float() if t.is_floating_point() else t for t in case))
    _paged_blocks_per_slot(monkeypatch, n_split)
    out = paged_attend(*case)
    torch.cuda.synchronize()
    assert (out.float() - want).abs().max().item() <= MMA_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [12, 16])
@pytest.mark.parametrize("bt", [16, 64])
@pytest.mark.parametrize("D", [64, 128])
def test_paged_kernel_wide_groups(gen, dtype, G, bt, D):
    """The paged kernel at G = 12 and 16 over ragged slots with NaN behind
    every dead entry: one launch on launches_wide, none on launches; pos 0
    gives exactly v_new in every head of the group."""
    case = _paged_case(gen, dtype, bt, [0, 1, 77, 1530, 4000], H=2 * G, KVH=2, D=D)
    want = paged_attend_plain(*(t.float() if t.is_floating_point() else t for t in case))
    before = paged_attend.launches, paged_attend.launches_wide
    out = paged_attend(*case, max_live=4000)
    torch.cuda.synchronize()
    assert (paged_attend.launches, paged_attend.launches_wide) == (before[0], before[1] + 1)
    assert (out.float() - want).abs().max().item() <= TOL[dtype]
    assert torch.equal(out[0, 0], case[6][0].repeat_interleave(G, dim=0))


@pytest.mark.parametrize("n_split", [1, 2, 5, 16])
def test_paged_wide_split_counts(gen, monkeypatch, n_split):
    """G = 16 at every few budgets up to the cap: each (slot, KV head, row
    group) merges its own blocks."""
    case = _paged_case(gen, torch.float32, 16, [0, 65, 700, 4094], H=64, KVH=4, D=128)
    want = paged_attend_plain(*case)
    _paged_blocks_per_slot(monkeypatch, n_split)
    out = paged_attend(*case)
    torch.cuda.synchronize()
    assert (out - want).abs().max().item() <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_group_16_head_dim_128(gen, dtype):
    """The prefill kernel at (128, 128) with G = 16 (Qwen3-235B-A22B's
    64 / 4 heads stacked into rows), a chunk off the tile grids."""
    q, k, v, sk, _ = _prefill_case(gen, dtype, 128, 128, 16, 1, 150, 37, 256, False, KVH=4)
    before = flash_prefill.launches
    out = flash_prefill(q, k, v, 37)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    want = flash_prefill_plain(q.float(), k.float(), v.float(), 37)
    assert (out.float() - want).abs().max().item() <= TOL[dtype]


WIDE_FORMS = [_wide_form(16, 128, bits, lse) for bits in (0, 8, 4) for lse in (False, True)]


@pytest.mark.parametrize("form", WIDE_FORMS, ids=[f"q{f[5]}-{'lse' if f[7] else 'norm'}" for f in WIDE_FORMS])
def test_wide_decode_call_is_one_device_kernel(gen, traced, form):
    """A G = 16 decode call in every form is one device kernel (its row
    groups are blocks of the one launch), as torch.profiler traces it in a
    fresh process."""
    call, want = _decode_form_call(gen, form)
    out = call()
    kernels = traced[("decode", "wide", WIDE_FORMS.index(form))]["kernels"]
    # bf16 over a bf16 cache at head dim 128 runs the tensor-core form
    name = "flash_decode_mma_kernel" if not form[5] else "flash_decode_kernel"
    assert len(kernels) == 1 and name in kernels[0], kernels
    _check_form(out, want, form, torch.bfloat16)


def test_wide_paged_call_is_one_device_kernel(gen, traced):
    """A G = 16 paged call (bf16: the tensor-core form) is one device
    kernel, as torch.profiler traces it in a fresh process."""
    trace = traced[("paged", "bfloat16", None, True)]
    assert trace["counted"] == 1
    kernels = trace["kernels"]
    assert len(kernels) == 1 and "paged_attention_mma_kernel" in kernels[0], kernels


def test_wide_and_narrow_calls_interleaved_repeat_exactly(gen):
    """G = 12 / 16 decode and paged calls interleaved with G <= 8 ones on one
    stream, three rounds: every round bit-identical to the first, so every
    (lane, KV head, row group) ticket is back at 0 after each call."""
    calls = [c for f, lens in ((_wide_form(16, 128, 0, False), (2048, 5)), (_wide_form(12, 64, 8, True), (700,)),
                               (DECODE_FORMS[0], (2048,)), (_wide_form(16, 128, 4, False), (1, 2048, 0)))
             for c, _ in (_decode_form_call(gen, f, lengths=lens),)]
    paged = [_paged_case(gen, torch.bfloat16, 16, [57, 1530, 0], H=64, KVH=4, D=128),
             _paged_case(gen, torch.bfloat16, 16, [300, 4000])]
    rounds = []
    for _ in range(3):
        outs = []
        for c, case in zip(calls, paged + paged):
            outs += [c(), paged_attend(*case)]
        rounds.append(outs)
    torch.cuda.synchronize()
    flat = lambda r: [t for x in r for t in (x if isinstance(x, tuple) else (x,))]  # noqa: E731
    for r in rounds[1:]:
        assert all(torch.equal(a, b) for a, b in zip(flat(rounds[0]), flat(r)))


def _small_model():
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.utils.random_init import random_llama_params

    cfg = ModelConfig.from_hf({
        "model_type": "llama", "vocab_size": 512, "hidden_size": 256, "intermediate_size": 512,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64,
        "rope_theta": 500000.0, "tie_word_embeddings": True,
    })
    window, edge = random_llama_params(cfg, range(2), torch.device("cpu"), torch.float32, seed=1)
    return cfg, window, edge


@pytest.mark.parametrize("mode", ["single", "dense", "paged"])
def test_engines_bf16_cache_under_f32_params(gen, monkeypatch, mode):
    """kv_dtype bf16 under f32 params (DNET_KV_BITS=16) serves on the card:
    the single-sequence engine, dense batched slots and paged + ragged
    slots, each against the same engine on the CPU (greedy tokens equal,
    logprobs within 2e-3)."""
    from dnet_tpu_torch.core.batch import BatchedEngine
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams

    cfg, window, edge = _small_model()
    if mode == "paged":
        for name, value in {"DNET_KV_PAGED": "1", "DNET_KV_RAGGED": "1", "DNET_KV_BLOCK_TOKENS": "8"}.items():
            monkeypatch.setenv(name, value)
    else:
        monkeypatch.delenv("DNET_KV_PAGED", raising=False)
    prompts = {f"p{n}": [(7 * i + n) % 500 + 1 for i in range(n)] for n in (5, 40, 69)}
    dec = DecodingParams(logprobs=True)
    got = {}
    for dev in ("cuda", "cpu"):
        kw = dict(max_seq=256, param_dtype="float32", device=dev, kv_dtype="bfloat16")
        if mode == "single":
            eng = LocalEngine.from_params(cfg, window, edge, **kw)
            got[dev] = {n: [(r.token_id, r.logprob) for r in eng.generate(ids, dec, max_tokens=12, nonce=n)]
                        for n, ids in prompts.items()}
            continue
        eng = BatchedEngine.from_params(cfg, window, edge, slots=4, **kw)
        toks = {}
        for n, ids in prompts.items():
            r = eng.prefill_and_sample(n, ids, dec)
            toks[n] = [(int(r.token[0]), float(r.logprob[0]))]
        for step in range(8):
            out, errs = eng.decode_batch({n: (t[-1][0], dec) for n, t in toks.items()},
                                         budgets={n: 8 - step for n in toks} if step >= 4 else None)
            assert not errs
            for n, r in out.items():
                toks[n].append((int(r.token[0]), float(r.logprob[0])))
        eng.close()
        got[dev] = toks
    for n in prompts:
        assert [t for t, _ in got["cuda"][n]] == [t for t, _ in got["cpu"][n]]
        assert max(abs(a[1] - b[1]) for a, b in zip(got["cuda"][n], got["cpu"][n])) <= 2e-3


@pytest.mark.parametrize("mode", ["single", "dense"])
def test_speculating_engines_match_cpu(gen, mode):
    """Prompt-lookup speculation (L = 4) on the card against the CPU, f32:
    the single-sequence engine's greedy stream, and on 4 dense slots three
    greedy lanes verifying together beside a seeded sampled lane on the
    plain step; equal greedy streams, the sampled lane equal to its serial
    stream on the same device (a torch.Generator's stream differs between
    the card and the CPU), every batched verify block one per-lane prefill
    launch a layer."""
    from dnet_tpu_torch.core.batch import BatchedEngine
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams

    cfg, window, edge = _small_model()
    prompts = {"g0": [7, 3, 11, 7, 3, 11, 7, 3] * 3, "g1": [5, 9, 5, 9, 5, 9, 2], "g2": list(range(40, 90)),
               "s": [250, 99, 13]}
    greedy, sampled = DecodingParams(temperature=0.0), DecodingParams(temperature=0.9, top_p=0.9, seed=42)
    got = {}
    for dev in ("cuda", "cpu"):
        kw = dict(max_seq=256, param_dtype="float32", device=dev, spec_lookahead=4)
        if mode == "single":
            eng = LocalEngine.from_params(cfg, window, edge, **kw)
            got[dev] = {n: [r.token_id for r in eng.generate(ids, greedy, max_tokens=24, nonce=n)]
                        for n, ids in prompts.items() if n != "s"}
            assert eng.spec_blocks > 0
            continue
        eng = BatchedEngine.from_params(cfg, window, edge, slots=4, **kw)
        toks = {n: [int(eng.prefill_and_sample(n, ids, sampled if n == "s" else greedy).token[0])]
                for n, ids in prompts.items()}
        lanes0, blocks0 = flash_prefill.launches_lanes, eng.spec_blocks
        while any(len(t) < 20 for t in toks.values()):
            live = {n: t for n, t in toks.items() if len(t) < 20}
            out, errs = eng.decode_batch({n: (t[-1], sampled if n == "s" else greedy) for n, t in live.items()},
                                         budgets={n: 20 - len(t) for n, t in live.items()})
            assert not errs
            for n, r in out.items():
                toks[n].append(int(r.token[0]))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert eng.spec_blocks > blocks0
            assert flash_prefill.launches_lanes - lanes0 == cfg.num_hidden_layers * (eng.spec_blocks - blocks0)
        eng.close()
        serial = LocalEngine.from_params(cfg, window, edge, max_seq=256, param_dtype="float32", device=dev)
        assert toks.pop("s")[:20] == [r.token_id for r in serial.generate(prompts["s"], sampled, max_tokens=20)]
        got[dev] = {n: t[:20] for n, t in toks.items()}
    assert got["cuda"] == got["cpu"]


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
@pytest.mark.parametrize("R", [1, 7, 1500])
@pytest.mark.parametrize("C", [2048, 2880, 8192])
@pytest.mark.parametrize("keep_of", ["1", "half", "all"])
def test_column_topk_kernel_selects_from_its_own_norms(gen, dtype, R, C, keep_of):
    """One launch picks the kept columns: its indices and bitmask equal
    topk_columns / pack_mask of the kernel's own norms (norms-only mode)
    bit for bit, those norms are within 2e-5 relative of the plain
    version, and a repeated call gives the same bits."""
    keep = {"1": 1, "half": C // 2, "all": C}[keep_of]
    x = _randn(gen, dtype, R, C) * 3
    before = column_sq_norms.launches
    idx, mask = column_topk(x, keep)
    idx2, mask2 = column_topk(x, keep)
    norms = column_sq_norms(x)
    torch.cuda.synchronize()
    assert column_sq_norms.launches == before + 3
    assert idx.dtype == torch.int32 and idx.shape == (keep,) and mask.shape == ((C + 7) // 8,)
    want = topk_columns(norms, keep)
    assert torch.equal(idx, want) and torch.equal(mask, pack_mask(want, C))
    assert torch.equal(idx, idx2) and torch.equal(mask, mask2)
    plain = column_sq_norms_plain(x)
    assert ((norms - plain).abs() / plain.abs().clamp(min=1e-30)).max().item() <= 2e-5


@pytest.mark.parametrize("C", [64, 2048, 2880])
def test_column_topk_kernel_ties_nan_inf(gen, C):
    """Exact ties (small integers, copied and zero columns), +inf and NaN
    norms: the kernel's columns are the plain version's at every keep (the
    plain version is the spec)."""
    g = torch.Generator().manual_seed(C)
    x = torch.randint(-6, 7, (5, C), generator=g).float()
    src, dst = torch.randint(0, C, (2, C // 2), generator=g)
    x[:, dst] = x[:, src]
    x[:, torch.randint(0, C, (3,), generator=g)] = 0.0
    x[2, C // 3] = float("nan")
    x[4, C // 5] = float("nan")
    x[0, C // 7] = float("inf")
    for dtype in (torch.float32, torch.bfloat16):
        xc = x.to(dtype).cuda()
        for keep in sorted({1, 2, 3, 4, C // 8, C // 2, C - 1, C}):
            idx, mask = column_topk(xc, keep)
            want = topk_columns(column_sq_norms_plain(xc), keep)
            assert torch.equal(idx, want), (dtype, keep)
            assert torch.equal(mask, pack_mask(want, C)), (dtype, keep)


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
@pytest.mark.parametrize("R", [1, 7, 1500])
@pytest.mark.parametrize("C,K,order", [(2049, 1000, "sorted"), (2048, 1, "sorted"), (2048, 2048, "all"),
                                       (2048, 1024, "unsorted"), (4096, 64, "sorted"), (2048, 1024, "sorted")])
def test_gather_kernel_strips_and_orders(gen, dtype, R, C, K, order):
    """The staged window (sorted idx, spans that fit), the element-by-element
    path (odd C, a span past the window, one row) and x read outside the
    span (unsorted idx) all give x[:, idx] bit for bit."""
    x = _randn(gen, dtype, R, C)
    if order == "all":
        idx = torch.arange(C, dtype=torch.int32, device="cuda")
    else:
        idx = _kept_idx(gen, C, K) if K > 1 else torch.tensor([C // 3], dtype=torch.int32, device="cuda")
        if order == "unsorted":
            idx = idx[torch.randperm(K, generator=torch.Generator().manual_seed(K)).cuda()].contiguous()
    out = gather_columns(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, gather_columns_plain(x, idx))
    assert torch.equal(out, torch.index_select(x, 1, idx))


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


def _strip_idx(D, K, lo, hi):
    """K sorted unique columns of D drawn from [lo, hi) only: the strips
    outside it have no kept column."""
    cols = torch.randperm(hi - lo, generator=torch.Generator().manual_seed(D + K))[:K] + lo
    return cols.sort().values.to(torch.int32).cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 7, 1500])
@pytest.mark.parametrize("D,K,gs,lo,hi", [(4099, 300, 64, 1100, 1900), (2048, 2048, 64, 0, 2048),
                                          (1001, 1, 0, 1000, 1001), (2051, 1000, 16, 0, 2051),
                                          (2048, 1500, 4, 0, 2048), (2051, 700, 3, 0, 2051)])
def test_dequant_scatter_kernel_strips_and_tails(gen, dtype, R, D, K, gs, lo, hi):
    """Strips with no kept column, every column kept, odd D (element stores:
    rows do not start 16-byte aligned), one kept column at the last, groups
    of 3, 4, 16 and 64 (3 and 4 narrower than a thread's columns; 3 divided,
    not shifted) and one per-tensor pair, at R = 1, 7 and 1500: both forms
    equal their plain versions bit for bit, one launch each."""
    kept = _randn(gen, dtype, R, K) * 3
    idx = _strip_idx(D, K, lo, hi)
    codes, scale, bias = quantize_q8(kept, gs)
    before = dequant_scatter_columns.launches
    out = dequant_scatter_columns(codes, idx, D, dtype, scale, bias, gs)
    plain = dequant_scatter_columns(kept, idx, D)
    torch.cuda.synchronize()
    assert dequant_scatter_columns.launches == before + 2
    assert out.dtype == dtype and torch.equal(out, dequant_scatter_columns_plain(codes, idx, D, dtype, scale, bias, gs))
    assert torch.equal(plain, dequant_scatter_columns_plain(kept, idx, D))


def test_column_kernels_never_take_the_plain_version(gen):
    x = _randn(gen, torch.float16, 4, 64)
    idx = torch.arange(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        column_sq_norms(x)
    with pytest.raises(ValueError):
        column_topk(x, 8)
    with pytest.raises(ValueError):  # int64 indices are not the kernel's
        gather_columns(x.float(), idx.long())
    with pytest.raises(ValueError):
        dequant_scatter_columns(x[:, :8], idx, 64)


# ---- the decode kernel's lane forms (continuous batching for every family) --

# lane lengths by lane count: idle lanes (0), a ring's lengths before, at and
# past W, and long lanes
LANE_FORM_LENGTHS = {
    "rotating": {1: [301], 3: [0, 129, 4096], 8: [0, 40, 128, 129, 300, 301, 700, 4096]},
    "mla": {1: [4096], 3: [0, 300, 4096], 8: [0, 1, 63, 64, 300, 1500, 2048, 4096]},
    "gathered": {1: [1500], 3: [0, 17, 1024], 8: [0, 1, 16, 17, 100, 1023, 2047, 2048]},
}
LANE_FORM_CASES = [(kind, dtype, bits) for kind in ("rotating", "mla", "gathered")
                   for dtype, bits in ((torch.float32, 0), (torch.bfloat16, 0), (torch.bfloat16, 8),
                                       (torch.bfloat16, 4))]


def _gathered_view(gen, dtype, bits, B, bt=16, S=2048):
    """One layer of a dense view [B, S, 8, 64] gathered (kv/store.py
    BlockStore.gather) from a pool of shuffled blocks: plain values in
    `dtype` (bf16 under an f32 q), or int8 / int4 codes and scales the
    port's write_kv made."""
    from dnet_tpu_torch.kv import BlockStore, PagedKVConfig

    kv_dtype = "bfloat16" if dtype == torch.float32 and not bits else str(dtype).split(".")[-1]

    class _Model:
        def init_kv(self, n_layers, batch, max_seq, dtype="bfloat16", quant_bits=0):
            return init_cache(KVConfig(n_layers, batch, max_seq, 8, 64, dtype=dtype, quant_bits=quant_bits),
                              torch.device("cuda"))

    n_blocks = B * S // bt
    store = BlockStore(_Model(), 1, PagedKVConfig(bt, n_blocks), kv_dtype, quant_bits=bits, session_tokens=S)
    rows = layer_slices(_Model().init_kv(1, n_blocks, bt, kv_dtype, bits), 0)
    write_kv(rows, _randn(gen, torch.bfloat16, n_blocks, bt, 8, 64), _randn(gen, torch.bfloat16, n_blocks, bt, 8, 64), 0)
    for name, t in rows.items():
        store.kv[name][0] = t
    ids = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(B)).reshape(B, S // bt).numpy()
    return layer_slices(store.gather(ids), 0)


def _lane_form_call(gen, kind, dtype, bits, B):
    """A zero-argument lane-form call over B lanes and its plain version's
    output in f32."""
    lengths = LANE_FORM_LENGTHS[kind][B]
    if kind == "rotating":
        k, v, scales = _ring(gen, dtype, bits, B=B)
        sinks = torch.randn(64, generator=gen, device="cuda")
        H, extra, slots = 64, {"rotating": True, "window": ROT_W, "sinks": sinks}, ROT_W
    elif kind == "mla":
        k, v, scales = _mla_cache(gen, dtype, bits, B=B)
        H, extra, slots = MLA_H, {"scale": MLA_SCALE}, 4096
    else:
        kvs = _gathered_view(gen, dtype, bits, B)
        k, v = kvs["k"], kvs["v"]
        scales = {n: kvs[n] for n in ("k_scale", "v_scale") if n in kvs}
        H, extra, slots = 32, {}, k.shape[1]
    q = _randn(gen, dtype, B, 1, H, k.shape[-1] * (2 if bits == 4 else 1))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    max_live = min(max(lengths), slots)
    kf, vf = (k, v) if bits else (k.float(), v.float())
    want = flash_decode_plain(q.float(), kf, vf, lens, **scales, **extra)
    return lambda: flash_decode_attend(q, k, v, lens, max_live, **scales, **extra), want, lens


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("kind,dtype,bits", LANE_FORM_CASES,
                         ids=[f"{k}-{str(d)[6:]}-q{b}" for k, d, b in LANE_FORM_CASES])
def test_lane_forms_match_plain(gen, kind, dtype, bits, B):
    """The lane forms the batched engine runs for every family: gpt-oss's
    ring with per-lane lengths (idle lanes, lengths past W), DeepSeek's MLA
    widths over lanes, Llama's widths over a view gathered from shuffled
    pool blocks; each lane as the plain version gives it, idle lanes 0."""
    call, want, lens = _lane_form_call(gen, kind, dtype, bits, B)
    out = call()
    torch.cuda.synchronize()
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert (out.float() - want).abs().max().item() <= TOL[dtype]
    assert not out[lens == 0].any()


def test_lane_forms_interleaved_repeat_exactly(gen):
    """Every lane form at B = 1, 3 and 8 interleaved on one stream, three
    rounds: each round's outputs bit-identical to the first's."""
    calls = [_lane_form_call(gen, kind, torch.bfloat16, bits, B)[0]
             for kind in ("rotating", "mla", "gathered") for bits in (0, 8) for B in (1, 3, 8)]
    rounds = [[c() for c in calls] for _ in range(3)]
    torch.cuda.synchronize()
    for r in rounds[1:]:
        assert all(torch.equal(a, b) for a, b in zip(rounds[0], r))


@pytest.mark.parametrize("window,bits", [(0, 0), (0, 8), (ROT_W, 0), (ROT_W, 4)])
def test_lane_cached_attend_matches_the_cpu(gen, window, bits):
    """ops/attention.py lane_cached_attend (the batched step's write and
    read) on the card against the CPU: the active lanes' rows written at
    their positions (a ring: p % W), the frozen lane's rows untouched, and
    the attention within the decode tolerance."""
    from dnet_tpu_torch.ops.attention import LaneStep, lane_cached_attend

    B, S = 4, ROT_W if window else 512
    kvs = layer_slices(init_cache(KVConfig(1, B, S, 8, 64, dtype="float32", quant_bits=bits), torch.device("cuda")), 0)
    write_kv(kvs, _randn(gen, torch.float32, B, S, 8, 64), _randn(gen, torch.float32, B, S, 8, 64), 0)
    pos = [5, 300, 0, 700] if window else [5, 300, 0, 511]
    lanes = [0, 1, 3]  # lane 2 frozen
    q = _randn(gen, torch.float32, B, 1, 32, 64)
    k_new, v_new = _randn(gen, torch.float32, B, 1, 8, 64), _randn(gen, torch.float32, B, 1, 8, 64)
    sinks = torch.randn(32, generator=gen, device="cuda") if window else None
    outs, caches = {}, {}
    for dev in ("cuda", "cpu"):
        c = {n: t.clone().to(dev) for n, t in kvs.items()}
        lengths = torch.tensor([p + 1 if b in lanes else 0 for b, p in enumerate(pos)], dtype=torch.int32, device=dev)
        step = LaneStep(torch.tensor(lanes, device=dev), torch.tensor([pos[b] for b in lanes], device=dev), lengths,
                        max(pos) + 1)
        outs[dev] = lane_cached_attend(q.to(dev), k_new.to(dev), v_new.to(dev), c, step,
                                       sinks=None if sinks is None else sinks.to(dev), window=window).cpu()
        caches[dev] = {n: t.cpu() for n, t in c.items()}
    assert (outs["cuda"] - outs["cpu"]).abs().max().item() <= TOL[torch.float32]
    for name in kvs:
        assert torch.equal(caches["cuda"][name][2], kvs[name][2].cpu())  # the frozen lane
        if not bits:
            assert torch.equal(caches["cuda"][name], caches["cpu"][name])


# every case the one-kernel-a-call tests hold, as (TRACE_CASES name, *its
# arguments): traced once each, in parallel, by the `traced` fixture
TRACED = (
    [("decode", "decode", i) for i in range(len(DECODE_FORMS))]
    + [("prefill", dqk, dv, dtype) for dqk, dv in PREFILL_WIDTHS for dtype in ("float32", "bfloat16")]
    + [("prefill_lanes", dqk, dv, dtype) for dqk, dv in PREFILL_WIDTHS for dtype in ("float32", "bfloat16")]
    + [("paged", dtype, n_split) for dtype in ("float32", "bfloat16") for n_split in (None, 16)]
    + [("column_topk", R) for R in (1, 1500)]
    + [("add",)]
    + [("decode", "wide", i) for i in range(len(WIDE_FORMS))]
    + [("paged", "bfloat16", None, True)]
)
