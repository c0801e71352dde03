#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, one JSON line each; any failure exits non-zero:
  device   the card (nvidia-smi name and power limit), torch/CUDA versions,
           and the kernels' build from dnet_tpu_torch/csrc (nvcc, sm_90a).
  kernels  each hand-written kernel against its plain PyTorch version at
           the main path's full widths (Llama-3.2-1B: H=32, KVH=8, D=64,
           S=4096): f32 within 1e-4; bf16 within 2e-2 of the plain version
           computed in f32 from the same bf16 inputs (the kernel rounds its
           output to bf16, ~4e-3 at |x| ~ 1, and sums in another order).
           Times (CUDA events), the plain version's and one PyTorch
           library call's (scaled_dot_product_attention, a yardstick the
           port never calls), and each call's bound on an H100 SXM.
  parity   a small model served by the engine on the GPU (kernels) and on
           the CPU (plain versions) from the same weights: prefill logits
           within 2e-3, equal 16-token greedy streams.
  step     one full-width greedy decode step: its synchronised wall time,
           the host's time to issue it, the device's busy time (profiler),
           the attention kernels' share, and the step's bound (its weights
           read once).
  serve    full-width Llama-3.2-1B with synthetic bf16 weights from a seed,
           written as a checkpoint and served by the port's HTTP server on
           loopback: a greedy chat completion, a seeded sampled one, and
           the greedy request streamed three times (equal content; TTFT and
           decode rate as medians); every attention call on that path must
           have gone through the kernels.
Continuous batching over the paged KV pool (DNET_KV_PAGED=1
DNET_KV_RAGGED=1), the second path:
  kernels      the ragged paged-attention kernel against its plain version
               at full width: 8 slots reading a pool of 2048 16-token blocks
               per layer x 16 layers through shuffled page tables, at the
               batch_serve mix of positions and at a ragged mix up to 4094;
               SDPA on a pre-gathered contiguous copy as the library call.
  batch_parity the batched engine (4 slots, 8-token blocks) on the GPU and
               on the CPU from the same f32 weights: four ragged prompts
               decoded together, by single steps and by an 8-step chunk;
               equal greedy streams, logprobs within 2e-3.
  batch_step   one batched decode step at 8 active lanes: wall, host issue,
               device busy (profiler) and the paged kernel's share.
  batch_serve  the same synthetic checkpoint served with --batch-slots 8: 8
               concurrent streamed requests (prompts of ~27 to 1,500 tokens,
               64 tokens each, one sampled with a seed); the paged kernel
               runs 16 times per decode step, the single-sequence decode
               kernel never, the prefill kernel 16 times per prompt chunk.
The pipelined shard ring, the third path (API node + two shard processes
over gRPC, the qsparse8 hop codec):
  kernels      the codec's three column kernels against their plain versions
               at the hop's widths (C=2048, K=1024 kept, gs=64; R=1, a decode
               hop, and R=1500, a prompt frame; bf16 and f32): norms within
               2e-5 relative, gather and dequant-scatter equal bit for bit;
               library yardsticks torch.linalg.vector_norm, index_select and
               index_copy_ (on a pre-dequantized copy).
  codec        one hop's whole encode and decode (qsparse8 and lossless) at
               R=1 and R=1500: host wall time per call and its device work.
  ring_serve   the serve phase's checkpoint served by two
               `dnet_tpu_torch.cli.shard` processes on the card (layers 0-7 and
               8-15) behind the port's API node with a hostfile on 127.0.0.1:
               lossless, the serve phase's requests, whose greedy and seeded
               sampled text must equal the serve phase's; qsparse8
               (DNET_WIRE_CODEC=qsparse8, pct 0.5, gs 64), the same plus a
               1,500-token prompt.  Every request returns 64 tokens; each
               shard's /health must show the column kernels launched once per
               hidden frame encoded (s0) or decoded (s1), and the attention
               kernels once per layer per step.  Per-frame host times on
               each shard are read after a warm-up request.
Then the kernels summary line, the card line, and the last line
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import random
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from argparse import Namespace

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call is the
# larger of its bytes over the memory rate and its operations over the peak
# rate for its type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
H, KVH, D, S, LAYERS = 32, 8, 64, 4096, 16
PREFILL_CASES = [(16, 0), (16, 100), (512, 0), (512, 100), (2048, 0), (2048, 100)]
DECODE_POSITIONS = [0, 255, 256, 1024, 4095]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MAX_TOKENS = 64
# printable ASCII: the byte tokenizer's visible characters, favoured with
# logit_bias so a random-weight model's completions are readable text
TEXT_BIAS = {str(t): 100.0 for t in range(32, 127)}
# continuous batching: slots, the default block size, the pool it sizes to
# (slots x S / BT blocks per layer), the serve burst's prompt lengths in
# tokens (chat template included) and the paged kernel's ragged mix
BATCH_SLOTS, BT = 8, 16
POOL_BLOCKS = BATCH_SLOTS * S // BT
BATCH_PROMPT_TOKENS = [27, 60, 150, 300, 520, 800, 1100, 1500]
PAGED_POSITIONS = [0, 15, 16, 100, 1023, 2047, 4000, 4094]
PAGED_ENV = {"DNET_KV_PAGED": "1", "DNET_KV_RAGGED": "1"}
PREFILL_CHUNK = 256  # the batched adapter's prompt chunk (api/strategies.py)
# the ring's hop codec: hidden width, kept columns (pct 0.5), quant group,
# frame rows (a decode hop, a prompt frame) and input copies rotated per
# timed call (16 x 6 MB at R=1500 in bf16 exceeds the 50 MB L2)
COL_C, COL_K, COL_GS, COL_ROWS, COL_COPIES = 2048, 1024, 64, (1, 1500), 16
RING_LAYERS = ([*range(0, 8)], [*range(8, 16)])
RING_ENV = {"DNET_WIRE_QSPARSE_PCT": "0.5", "DNET_WIRE_GROUP_SIZE": "64"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_time_ms(fn, layers: int, reps: int = 20) -> float:
    """Median device time of one call.  A sleep kernel holds the stream
    while the host enqueues `reps` calls, so they run back to back and the
    host's launch cost is not counted; call r reads layer r % layers of a
    16-layer cache (128 MB at S=4096), so it finds K/V cold in the 50 MB L2
    as the model's next layer would."""
    for r in range(3):
        fn(r % layers)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # ~60 ms
        start.record()
        for r in range(reps):
            fn(r % layers)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def prefill_bound(T: int, pos: int, dtype) -> tuple:
    """(ms, bound_by) for causal prefill at (T, pos): q, the live K/V rows
    and the output move once; 4*D operations per (head, query, key) pair."""
    size = torch.tensor([], dtype=dtype).element_size()
    keys = min(pos + T, S)
    nbytes = size * (2 * T * H * D + 2 * keys * KVH * D)
    pairs = sum(min(pos + i + 1, S) for i in range(T))
    ops = 4 * H * D * pairs
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def decode_bound(pos: int, dtype) -> tuple:
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * (2 * H * D + 2 * (pos + 1) * KVH * D)
    ops = 4 * H * D * (pos + 1)
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


@contextlib.contextmanager
def environ(values: dict):
    """Set environment variables for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def paged_bound(positions: list, dtype) -> tuple:
    """(ms, bound_by) for one ragged paged-attention call: q, the live K/V
    rows, the new rows and the output move once, with the live table
    entries and the positions; 4*D operations per (head, key) pair, the new
    row included."""
    size = torch.tensor([], dtype=dtype).element_size()
    B, live = len(positions), sum(positions)
    nbytes = size * (2 * B * H * D + 2 * live * KVH * D + 2 * B * KVH * D)
    nbytes += 4 * (sum(-(-p // BT) for p in positions) + B)
    ops = 4 * H * D * (live + B)
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def phase_paged_kernels(main_positions: list) -> dict:
    """The paged kernel at full width: 8 slots over a 16-layer pool of
    POOL_BLOCKS blocks per layer, each slot's blocks scattered through it
    (dead table entries 0, as the engine pads them).  Returns the main
    path's bf16 case."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.ops.paged_attention import paged_attend, paged_attend_plain

    g = torch.Generator(device="cuda").manual_seed(2)
    perm = torch.randperm(POOL_BLOCKS, generator=torch.Generator().manual_seed(2))
    per_slot = POOL_BLOCKS // BATCH_SLOTS
    main = None
    for dtype in (torch.float32, torch.bfloat16):
        shape = (LAYERS, POOL_BLOCKS, BT, KVH, D)
        kp = torch.randn(shape, generator=g, device="cuda").to(dtype)
        vp = torch.randn(shape, generator=g, device="cuda").to(dtype)
        for positions in (main_positions, PAGED_POSITIONS):
            B = len(positions)
            tables = torch.zeros(B, per_slot, dtype=torch.int32)
            for b, p in enumerate(positions):
                n = -(-p // BT)
                tables[b, :n] = perm[b * per_slot : b * per_slot + n].to(torch.int32)
            tables_d = tables.cuda()
            pos_cpu = torch.tensor(positions, dtype=torch.int32)
            pos = pos_cpu.cuda()
            q = torch.randn(B, 1, H, D, generator=g, device="cuda").to(dtype)
            kn = torch.randn(B, KVH, D, generator=g, device="cuda").to(dtype)
            vn = torch.randn(B, KVH, D, generator=g, device="cuda").to(dtype)
            max_live = max(positions)
            out = paged_attend(q, kp[0], vp[0], tables_d, pos, kn, vn, max_live=max_live)
            torch.cuda.synchronize()
            want = paged_attend_plain(q.float(), kp[0].float(), vp[0].float(), tables_d, pos_cpu,
                                      kn.float(), vn.float())
            err = (out.float() - want).abs().max().item()
            check(out.shape == q.shape and bool(torch.isfinite(out).all()), "paged output")
            check(err <= TOL[dtype], f"paged positions={positions} {dtype}: max err {err}")
            # the library yardstick: each layer's live rows gathered once,
            # outside the timing, into contiguous [B, KVH, keys, D] with the
            # new row at pos[b]; rows past pos[b] are masked
            keys = max_live + 1
            j = torch.arange(keys, device="cuda")
            rows = (tables_d.long()[:, (j // BT).clamp(max=per_slot - 1)] * BT + j % BT)  # [B, keys]
            at_pos = j[None, :] == pos.long()[:, None]

            def contiguous(pool, new):
                flat = pool.reshape(LAYERS, POOL_BLOCKS * BT, KVH, D)
                c = flat[:, rows]  # [L, B, keys, KVH, D]
                c = torch.where(at_pos[None, :, :, None, None], new[None, :, None], c)
                return c.transpose(2, 3).contiguous()

            kc, vc = contiguous(kp, kn), contiguous(vp, vn)
            mask = (j[None, :] <= pos.long()[:, None])[:, None, None, :]
            qt = q.transpose(1, 2)

            def lib(l):
                return sdpa(qt, kc[l], vc[l], attn_mask=mask, enable_gqa=True)

            lib_err = (lib(0).transpose(1, 2).float() - want).abs().max().item()
            check(lib_err <= TOL[dtype], f"paged library yardstick disagrees: {lib_err}")
            bound, by = paged_bound(positions, dtype)
            row = {
                "phase": "kernels", "kernel": "paged_attend", "dtype": str(dtype).split(".")[-1],
                "positions": positions, "sum_pos": sum(positions), "slots": B, "bt": BT,
                "pool_blocks": POOL_BLOCKS, "layers": LAYERS, "H": H, "KVH": KVH, "D": D,
                "max_err": err, "tol": TOL[dtype],
                "kernel_ms": device_time_ms(
                    lambda l: paged_attend(q, kp[l], vp[l], tables_d, pos, kn, vn, max_live=max_live),
                    LAYERS),
                "plain_ms": device_time_ms(
                    lambda l: paged_attend_plain(q, kp[l], vp[l], tables_d, pos_cpu, kn, vn), LAYERS, 5),
                "library_ms": device_time_ms(lib, LAYERS),
                "library_call": "scaled_dot_product_attention on a pre-gathered contiguous copy "
                                "(the gather is not timed)",
                "library_max_err": lib_err,
                "bound_ms": bound, "bound_by": by,
            }
            emit(row)
            if dtype == torch.bfloat16 and positions is main_positions:
                main = row
            del kc, vc
        del kp, vp
    torch.cuda.empty_cache()
    return main


def bytes_ops_bound(nbytes: int, ops: int, dtype) -> tuple:
    """(ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def phase_column_kernels() -> dict:
    """The hop codec's kernels at the ring's widths; returns the decode
    hop's (R=1) bf16 row per kernel, the frame that runs once per token."""
    from dnet_tpu_torch.compression.ops import (
        column_sq_norms,
        column_sq_norms_plain,
        dequant_scatter_columns,
        dequant_scatter_columns_plain,
        gather_columns,
        gather_columns_plain,
        quantize_q8,
        topk_columns,
    )

    g = torch.Generator(device="cuda").manual_seed(3)
    main = {}
    C, K, GS = COL_C, COL_K, COL_GS
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.tensor([], dtype=dtype).element_size()
        name = str(dtype).split(".")[-1]
        for R in COL_ROWS:
            xs = [torch.randn(R, C, generator=g, device="cuda").mul_(3).to(dtype) for _ in range(COL_COPIES)]
            # the kept columns as the codec picks them: the top K norms
            idx = topk_columns(column_sq_norms_plain(xs[0]), K)
            idx_long = idx.long()
            shape = {"R": R, "C": C, "K": K}

            def emit_row(kernel, err, kernel_fn, plain_fn, lib_fn, lib_call, nbytes, ops, **extra):
                bound, by = bytes_ops_bound(nbytes, ops, torch.float32)
                row = {"phase": "kernels", "kernel": kernel, "dtype": name, **shape, **extra,
                       "max_err": err, "kernel_ms": device_time_ms(kernel_fn, COL_COPIES),
                       "plain_ms": device_time_ms(plain_fn, COL_COPIES, 5),
                       "library_ms": device_time_ms(lib_fn, COL_COPIES), "library_call": lib_call,
                       "bytes": nbytes, "bound_ms": bound, "bound_by": by}
                emit(row)
                if dtype == torch.bfloat16 and R == 1 and kernel not in main:
                    main[kernel] = row

            out = column_sq_norms(xs[0])
            torch.cuda.synchronize()
            want = column_sq_norms_plain(xs[0])
            rel = ((out - want).abs() / want.abs().clamp(min=1e-30)).max().item()
            check(out.shape == (C,) and bool(torch.isfinite(out).all()), "norms output")
            check(rel <= 2e-5, f"column_sq_norms R={R} {name}: relative err {rel}")
            check(torch.equal(out, column_sq_norms(xs[0])), "column_sq_norms is not repeatable")
            emit_row("column_sq_norms", (out - want).abs().max().item(),
                     lambda l: column_sq_norms(xs[l]), lambda l: column_sq_norms_plain(xs[l]),
                     lambda l: torch.linalg.vector_norm(xs[l], 2, 0, dtype=torch.float32),
                     "torch.linalg.vector_norm(x, 2, 0, dtype=float32) (the square root, not squared)",
                     R * C * size + C * 4, 2 * R * C, max_rel_err=rel, tol_rel=2e-5)

            out = gather_columns(xs[0], idx)
            torch.cuda.synchronize()
            check(torch.equal(out, gather_columns_plain(xs[0], idx)), f"gather_columns R={R} {name} not bit-equal")
            check(torch.equal(torch.index_select(xs[0], 1, idx), out), "index_select disagrees")
            emit_row("gather_columns", 0.0, lambda l: gather_columns(xs[l], idx),
                     lambda l: gather_columns_plain(xs[l], idx), lambda l: torch.index_select(xs[l], 1, idx),
                     "torch.index_select(x, 1, idx)", 2 * R * K * size + K * 4, 0)

            kept = [gather_columns_plain(x, idx) for x in xs]
            q = [quantize_q8(k, GS) for k in kept]
            deq = [dequant_scatter_columns_plain(c, idx, C, dtype, sc, b, GS)[:, idx_long].contiguous()
                   for c, sc, b in q]
            outs = [torch.zeros(R, C, dtype=dtype, device="cuda") for _ in range(COL_COPIES)]
            codes, scale, bias = q[0]
            out = dequant_scatter_columns(codes, idx, C, dtype, scale, bias, GS)
            torch.cuda.synchronize()
            check(torch.equal(out, dequant_scatter_columns_plain(codes, idx, C, dtype, scale, bias, GS)),
                  f"dequant_scatter_columns R={R} {name} not bit-equal")
            check(torch.equal(outs[0].clone().index_copy_(1, idx_long, deq[0]), out), "index_copy_ disagrees")
            G = scale.shape[1]
            emit_row("dequant_scatter_columns", 0.0,
                     lambda l: dequant_scatter_columns(q[l][0], idx, C, dtype, q[l][1], q[l][2], GS),
                     lambda l: dequant_scatter_columns_plain(q[l][0], idx, C, dtype, q[l][1], q[l][2], GS),
                     lambda l: outs[l].index_copy_(1, idx_long, deq[l]),
                     "out.index_copy_(1, idx, kept) on a pre-dequantized copy (the dequant is not timed)",
                     R * K + 2 * R * G * 4 + K * 4 + R * C * size, 2 * R * K, gs=GS, form="qsparse8")
            out = dequant_scatter_columns(kept[0], idx, C)
            torch.cuda.synchronize()
            check(torch.equal(out, dequant_scatter_columns_plain(kept[0], idx, C)), "plain scatter not bit-equal")
            emit_row("dequant_scatter_columns", 0.0, lambda l: dequant_scatter_columns(kept[l], idx, C),
                     lambda l: dequant_scatter_columns_plain(kept[l], idx, C),
                     lambda l: outs[l].index_copy_(1, idx_long, kept[l]), "out.index_copy_(1, idx, kept)",
                     R * K * size + K * 4 + R * C * size, 0, form="sparse_v1")
            del xs, kept, q, deq, outs
    torch.cuda.empty_cache()
    return main


def phase_codec_host() -> None:
    """One hidden hop's encode and decode as a shard runs them, qsparse8
    against lossless at the ring's widths (bf16 [1, R, 2048]): the host's
    wall time per call, synchronised, and the device work of one call
    (kernel launches and device time, torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dnet_tpu_torch.compression.wire import compress_tensor, decompress_tensor_device
    from dnet_tpu_torch.utils.serialization import bytes_to_device, tensor_to_bytes

    def wall_ms(fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def device_work(fn) -> dict:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        return {"launches": len(kernels), "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3}

    g = torch.Generator(device="cuda").manual_seed(4)
    for R in COL_ROWS:
        x = torch.randn(1, R, COL_C, generator=g, device="cuda").to(torch.bfloat16)
        q = compress_tensor(x, 0.5, "bfloat16", 8, COL_GS)
        lossless = tensor_to_bytes(x, "bfloat16")
        calls = {
            "qsparse8_encode": lambda: compress_tensor(x, 0.5, "bfloat16", 8, COL_GS),
            "qsparse8_decode": lambda: decompress_tensor_device(*q, "cuda"),
            "lossless_encode": lambda: tensor_to_bytes(x, "bfloat16"),
            "lossless_decode": lambda: bytes_to_device(*lossless, "cuda"),
        }
        emit({"phase": "codec", "gpu": gpu_line(), "R": R, "C": COL_C,
              "payload_bytes": {"qsparse8": len(q[0]), "lossless": len(lossless[0])},
              "host_wall_ms": {k: wall_ms(fn) for k, fn in calls.items()},
              "device": {k: device_work(fn) for k, fn in calls.items()}})


def phase_kernels(main_T: int, main_pos: int) -> dict:
    """Every case's line; returns the main path's bf16 case per kernel."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dnet_tpu_torch.ops.flash_attention import flash_prefill, flash_prefill_plain
    from dnet_tpu_torch.ops.flash_decode import flash_decode_attend, flash_decode_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        kc = torch.randn(LAYERS, 1, S, KVH, D, generator=g, device="cuda").to(dtype)
        vc = torch.randn(LAYERS, 1, S, KVH, D, generator=g, device="cuda").to(dtype)
        for T, pos in dict.fromkeys(PREFILL_CASES + [(main_T, 0)]):
            q = torch.randn(1, T, H, D, generator=g, device="cuda").to(dtype)
            out = flash_prefill(q, kc[0], vc[0], pos)
            torch.cuda.synchronize()
            want = flash_prefill_plain(q.float(), kc[0].float(), vc[0].float(), pos)
            err = (out.float() - want).abs().max().item()
            check(out.shape == q.shape and bool(torch.isfinite(out).all()), "prefill output")
            check(err <= TOL[dtype], f"prefill T={T} pos={pos} {dtype}: max err {err}")
            keys = pos + T
            qt = q.transpose(1, 2)
            mask = (torch.arange(keys, device="cuda")[None, :]
                    <= pos + torch.arange(T, device="cuda")[:, None])

            def lib(l):
                return sdpa(qt, kc[l, :, :keys].transpose(1, 2), vc[l, :, :keys].transpose(1, 2),
                            attn_mask=mask, enable_gqa=True)

            bound, by = prefill_bound(T, pos, dtype)
            row = {
                "phase": "kernels", "kernel": "flash_prefill", "dtype": str(dtype).split(".")[-1],
                "T": T, "pos": pos, "S": S, "H": H, "KVH": KVH, "D": D,
                "max_err": err, "tol": TOL[dtype],
                "kernel_ms": device_time_ms(lambda l: flash_prefill(q, kc[l], vc[l], pos), LAYERS),
                "plain_ms": device_time_ms(lambda l: flash_prefill_plain(q, kc[l], vc[l], pos), LAYERS, 5),
                "library_ms": device_time_ms(lib, LAYERS),
                "bound_ms": bound, "bound_by": by,
            }
            emit(row)
            if dtype == torch.bfloat16 and (T, pos) == (main_T, 0):
                main["flash_prefill"] = row
        for pos in dict.fromkeys(DECODE_POSITIONS + [main_pos]):
            q = torch.randn(1, 1, H, D, generator=g, device="cuda").to(dtype)
            out = flash_decode_attend(q, kc[0], vc[0], pos)
            torch.cuda.synchronize()
            want = flash_decode_plain(q.float(), kc[0].float(), vc[0].float(), pos)
            err = (out.float() - want).abs().max().item()
            check(out.shape == q.shape and bool(torch.isfinite(out).all()), "decode output")
            check(err <= TOL[dtype], f"decode pos={pos} {dtype}: max err {err}")
            qt = q.transpose(1, 2)

            def lib(l):
                return sdpa(qt, kc[l, :, : pos + 1].transpose(1, 2),
                            vc[l, :, : pos + 1].transpose(1, 2), enable_gqa=True)

            bound, by = decode_bound(pos, dtype)
            row = {
                "phase": "kernels", "kernel": "flash_decode", "dtype": str(dtype).split(".")[-1],
                "pos": pos, "S": S, "H": H, "KVH": KVH, "D": D,
                "max_err": err, "tol": TOL[dtype],
                "kernel_ms": device_time_ms(lambda l: flash_decode_attend(q, kc[l], vc[l], pos), LAYERS),
                "plain_ms": device_time_ms(lambda l: flash_decode_plain(q, kc[l], vc[l], pos), LAYERS, 5),
                "library_ms": device_time_ms(lib, LAYERS),
                "bound_ms": bound, "bound_by": by,
            }
            emit(row)
            if dtype == torch.bfloat16 and pos == main_pos:
                main["flash_decode"] = row
        del kc, vc
    torch.cuda.empty_cache()
    return main


def _small_model():
    """The parity phases' model: small, f32, with the kernels' head dim."""
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.utils.random_init import random_llama_params

    cfg = ModelConfig.from_hf({
        "model_type": "llama", "vocab_size": 512, "hidden_size": 256,
        "intermediate_size": 512, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 64, "rope_theta": 500000.0,
        "tie_word_embeddings": True,
    })
    window, edge = random_llama_params(cfg, range(2), torch.device("cpu"), torch.float32, seed=1)
    return cfg, window, edge


def phase_parity() -> None:
    """The engine on the GPU (kernels) against the engine on the CPU (plain
    versions), same f32 weights: a small model with the kernels' head dim."""
    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams

    cfg, window, edge = _small_model()
    engines = {
        dev: LocalEngine.from_params(cfg, window, edge, max_seq=256, param_dtype="float32", device=dev)
        for dev in ("cuda", "cpu")
    }
    prompt = list(range(1, 70))
    logits = {dev: e.prefill("p", prompt).float().cpu() for dev, e in engines.items()}
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    check(bool(torch.isfinite(logits["cuda"]).all()) and logits["cuda"].shape == (1, 512), "parity logits")
    check(err <= 2e-3, f"GPU vs CPU prefill logits: max err {err}")
    streams = {
        dev: [r.token_id for r in e.generate(prompt, DecodingParams(), max_tokens=16, nonce="g")]
        for dev, e in engines.items()
    }
    check(streams["cuda"] == streams["cpu"], f"greedy streams differ: {streams}")
    emit({"phase": "parity", "logits_max_err": err, "tol": 2e-3, "greedy_tokens": len(streams["cuda"])})


def phase_batch_parity() -> None:
    """The batched engine on the GPU (paged kernel) against the batched
    engine on the CPU (plain version), same f32 weights: four prompts of
    ragged lengths across 8-token block edges decoded together, by single
    steps and then by one budgeted 8-step chunk."""
    from dnet_tpu_torch.core.batch import BatchedEngine
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.ops.paged_attention import paged_attend

    cfg, window, edge = _small_model()
    prompts = {f"p{n}": [(7 * i + n) % 500 + 1 for i in range(n)] for n in (5, 17, 40, 69)}
    dec = DecodingParams(logprobs=True)
    streams = {}
    for dev in ("cuda", "cpu"):
        with environ(dict(PAGED_ENV, DNET_KV_BLOCK_TOKENS="8")):
            eng = BatchedEngine.from_params(cfg, window, edge, slots=4, max_seq=256,
                                            param_dtype="float32", device=dev)
        paged_attend.launches = 0
        got = {}
        for n, ids in prompts.items():
            r = eng.prefill_and_sample(n, ids, dec)
            got[n] = [(int(r.token[0]), float(r.logprob[0]))]
        for step in range(16):
            reqs = {n: (got[n][-1][0], dec) for n in prompts}
            out, errs = eng.decode_batch(reqs, budgets={n: 16 - step for n in reqs} if step >= 8 else None)
            check(not errs, f"batched decode errors: {errs}")
            for n, r in out.items():
                got[n].append((int(r.token[0]), float(r.logprob[0])))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = paged_attend.launches
            steps = eng.decode_steps
        for n in prompts:
            eng.end_session(n)
        eng.kv_pool.check_conservation([])
        streams[dev] = got
    check(launches == cfg.num_hidden_layers * steps and steps == 16,
          f"paged launches {launches} for {steps} batched steps")
    toks = {dev: {n: [t for t, _ in s] for n, s in got.items()} for dev, got in streams.items()}
    check(toks["cuda"] == toks["cpu"], f"batched greedy streams differ: {toks}")
    err = max(abs(a[1] - b[1]) for n in prompts for a, b in zip(streams["cuda"][n], streams["cpu"][n]))
    check(err <= 2e-3, f"batched logprobs differ by {err}")
    emit({"phase": "batch_parity", "slots": 4, "bt": 8, "prompt_tokens": [len(p) for p in prompts.values()],
          "tokens_per_stream": len(toks["cuda"]["p5"]), "logprob_max_err": err, "tol": 2e-3,
          "paged_launches": launches, "decode_steps": steps})


def _batch_prompts() -> list:
    """Chat contents whose templated prompts are BATCH_PROMPT_TOKENS long
    under the byte tokenizer (distinct texts, so no two requests agree)."""
    from dnet_tpu_torch.utils.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    overhead = len(tok.encode(tok.apply_chat_template([{"role": "user", "content": ""}])))
    rng = random.Random(0)
    words = ["GPU", "memory", "kernel", "block", "page", "table", "slot", "token", "batch", "cache"]
    out = []
    for i, n in enumerate(BATCH_PROMPT_TOKENS):
        text = f"Request {i}: " + " ".join(rng.choice(words) for _ in range(n))
        out.append(text[: n - overhead])
    return out


def phase_batch_step(cfg, window, edge, prompt_lens: list) -> dict:
    """Where one batched decode step's time goes at 8 active lanes (the
    batch_serve prompts, single steps): synchronised wall, host issue,
    device busy per step from torch.profiler, and the paged kernel's share
    of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dnet_tpu_torch.core.batch import BatchedEngine
    from dnet_tpu_torch.core.types import DecodingParams

    with environ(PAGED_ENV):
        eng = BatchedEngine.from_params(cfg, window, edge, slots=BATCH_SLOTS, max_seq=S, device="cuda")
    d = DecodingParams()
    last = {}
    for i, n in enumerate(prompt_lens):
        last[f"s{i}"] = int(eng.prefill_and_sample(f"s{i}", [(t % 250) + 1 for t in range(n)], d).token[0])

    def step():
        out, errs = eng.decode_batch({k: (t, d) for k, t in last.items()})
        check(not errs, f"batched step errors: {errs}")
        for k, r in out.items():
            last[k] = int(r.token[0])

    for _ in range(5):
        step()
    wall, issue = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        step()  # ends on the step's one device-to-host read
        wall.append((time.perf_counter() - t0) * 1e3)
        issue.append(eng.last_dispatch_ms)
    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    paged_ms = sum(e.self_device_time_total for e in kernels if "paged_" in e.name) / 1e3 / steps
    wall_ms = statistics.median(wall)
    weight_bytes = sum(t.numel() * t.element_size() for p in window for t in p.values())
    weight_bytes += edge["embed"]["weight"].numel() * edge["embed"]["weight"].element_size()
    pos = [int(eng.pos[eng.slot_of[k]]) for k in last]
    kv_bytes = 2 * LAYERS * sum(pos) * KVH * D * eng.kv_store.kv["k"].element_size()
    row = {"phase": "batch_step", "gpu": gpu_line(), "active_lanes": len(last), "positions": pos,
           "steps": len(wall), "wall_ms": wall_ms, "host_issue_ms": statistics.median(issue),
           "device_busy_ms": device_ms, "device_idle_share": 1.0 - device_ms / wall_ms,
           "paged_kernel_ms": paged_ms, "kernel_launches": len(kernels) // steps,
           "weight_bytes": weight_bytes, "kv_bytes": kv_bytes,
           "bound_ms": (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
           "weight_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3}
    emit(row)
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return row


def _post(url: str, body: dict) -> dict:
    stream = body.get("stream", False)
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        status = resp.status
        if not stream:
            data = json.loads(resp.read())
            return {"status": status, "body": data, "s": time.perf_counter() - t0,
                    "content": data["choices"][0]["message"]["content"],
                    "tokens": data["usage"]["completion_tokens"]}
        content, t_first, tokens, arrivals = [], None, None, []
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: {"):
                continue
            ev = json.loads(line[len("data: "):])
            check("error" not in ev, f"stream error event: {ev.get('error')}")
            for c in ev["choices"]:
                if c["delta"].get("content"):
                    t_first = t_first or time.perf_counter()
                    arrivals.append(time.perf_counter())
                    content.append(c["delta"]["content"])
            if ev.get("usage"):
                tokens = ev["usage"]["completion_tokens"]
        t_end = time.perf_counter()
        gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
        return {"status": status, "s": t_end - t0, "ttft_s": (t_first or t_end) - t0,
                "content": "".join(content), "tokens": tokens,
                "decode_s": t_end - (t_first or t_end), "t0": t0, "t_first": t_first, "t_end": t_end,
                "gap_median_s": statistics.median(gaps) if gaps else None,
                "gap_max_s": max(gaps) if gaps else None}


async def _drive(args: Namespace, requests: list, concurrent: bool = False) -> list:
    """Serve args' model in this process and send `requests` (in order, or
    all at once); returns the results, the kernels' launches during the
    requests, the load time and /health after them."""
    from dnet_tpu_torch.api.server import serve_async
    from dnet_tpu_torch.ops.flash_attention import flash_prefill
    from dnet_tpu_torch.ops.flash_decode import flash_decode_attend
    from dnet_tpu_torch.ops.paged_attention import paged_attend

    loop = asyncio.get_running_loop()
    server = asyncio.ensure_future(serve_async(args))
    base = f"http://127.0.0.1:{args.http_port}"
    t0 = time.perf_counter()
    while True:
        check(not server.done(), "server exited during start-up")
        try:
            health = await loop.run_in_executor(
                None, lambda: json.loads(urllib.request.urlopen(base + "/health", timeout=5).read())
            )
            if health.get("model"):
                break
        except OSError:
            pass
        check(time.perf_counter() - t0 < 600, "server not ready within 600 s")
        await asyncio.sleep(0.5)
    load_s = time.perf_counter() - t0
    url = base + "/v1/chat/completions"
    try:
        flash_prefill.launches = 0
        flash_decode_attend.launches = 0
        paged_attend.launches = 0
        if concurrent:
            results = await asyncio.gather(
                *(loop.run_in_executor(None, _post, url, body) for body in requests))
        else:
            results = []
            for body in requests:
                results.append(await loop.run_in_executor(None, _post, url, body))
        torch.cuda.synchronize()
        launches = {"flash_prefill": flash_prefill.launches, "flash_decode": flash_decode_attend.launches,
                    "paged_attend": paged_attend.launches}
        health = await loop.run_in_executor(
            None, lambda: json.loads(urllib.request.urlopen(base + "/health", timeout=5).read()))
    finally:
        if not server.done():
            signal.raise_signal(signal.SIGTERM)  # the server's own shutdown path
        await server
    return results, launches, load_s, health


def phase_step(cfg, window, edge, n_prompt: int) -> None:
    """Where a full-width greedy decode step's time goes: the synchronised
    wall time of a step, the host's time to issue its launches, and the
    device's busy time per step from torch.profiler (kernel time summed),
    with the attention kernels' share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dnet_tpu_torch.core.engine import LocalEngine
    from dnet_tpu_torch.core.types import DecodingParams

    eng = LocalEngine.from_params(cfg, window, edge, max_seq=S, device="cuda")
    d = DecodingParams()
    tok = int(eng.prefill_and_sample("s", list(range(1, n_prompt + 1)), d).token[0])
    for _ in range(5):
        eng.decode_step("s", tok, d)
    torch.cuda.synchronize()
    wall, issue = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        eng.decode_step("s", tok, d)
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.decode_step("s", tok, d)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    attn_ms = sum(e.self_device_time_total for e in kernels if "flash_" in e.name) / 1e3 / steps
    wall_ms = statistics.median(wall)
    # a step reads every weight once: its bound at the memory rate
    weight_bytes = sum(t.numel() * t.element_size() for p in window for t in p.values())
    weight_bytes += edge["embed"]["weight"].numel() * edge["embed"]["weight"].element_size()
    emit({"phase": "step", "steps": len(wall), "pos": eng.sessions["s"].pos,
          "wall_ms": wall_ms, "host_issue_ms": statistics.median(issue),
          "device_busy_ms": device_ms, "device_idle_share": 1.0 - device_ms / wall_ms,
          "attention_kernels_ms": attn_ms, "kernel_launches": len(kernels) // steps,
          "weight_bytes": weight_bytes, "bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3})
    eng.end_session("s")


def phase_serve(prompt_text: str, n_prompt: int) -> tuple:
    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.models.convert import hf_tensors
    from dnet_tpu_torch.utils.checkpoint import save_checkpoint
    from dnet_tpu_torch.utils.random_init import LLAMA_3_2_1B_CONFIG, random_llama_params

    tmp = os.path.join(tempfile.mkdtemp(prefix="dnet-torch-smoke-"), "llama-3.2-1b-synthetic")
    try:
        t0 = time.perf_counter()
        cfg = ModelConfig.from_hf(LLAMA_3_2_1B_CONFIG)
        window, edge = random_llama_params(cfg, range(cfg.num_hidden_layers), torch.device("cuda"),
                                           torch.bfloat16, seed=0)
        phase_step(cfg, window, edge, n_prompt)
        batch_step = phase_batch_step(cfg, window, edge, BATCH_PROMPT_TOKENS)
        save_checkpoint(tmp, LLAMA_3_2_1B_CONFIG, hf_tensors(window, edge))
        del window, edge
        torch.cuda.empty_cache()
        write_s = time.perf_counter() - t0
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        args = Namespace(
            host="127.0.0.1", http_port=port, model=tmp, models_dir="", device="cuda",
            max_seq_len=S, param_dtype="bfloat16", max_concurrent=8, request_timeout_s=600.0,
        )
        chat = {"model": "llama-3.2-1b-synthetic", "max_tokens": MAX_TOKENS, "temperature": 0,
                "messages": [{"role": "user", "content": prompt_text}], "logit_bias": TEXT_BIAS}
        sampled = dict(chat, temperature=0.8, top_p=0.95, seed=1234)
        bodies = [{"greedy": chat, "streamed": dict(chat, stream=True), "sampled": sampled}[k] for k in SERVE_KINDS]
        results, launches, load_s, _ = asyncio.run(_drive(args, bodies))
        row = serve_row(results, launches, write_s, load_s)
        batched = phase_batch_serve(tmp, port, batch_step)
        long_body = dict(chat, stream=True, messages=[{"role": "user", "content": _batch_prompts()[-1]}])
        ring = phase_ring_serve(tmp, bodies, results, row, long_body)
    finally:
        shutil.rmtree(os.path.dirname(tmp), ignore_errors=True)
    return row, batched, ring


# the serve and ring_serve requests: one greedy, one seeded sampled and three
# greedy streamed (their TTFT and decode rate are read as medians)
SERVE_KINDS = ("greedy", "streamed", "sampled", "streamed", "streamed")


def streamed_rates(results: list) -> dict:
    """Median TTFT and decode rate of the streamed requests."""
    runs = [r for k, r in zip(SERVE_KINDS, results) if k == "streamed"]
    rates = [(r["tokens"] - 1) / max(r["decode_s"], 1e-9) for r in runs]
    return {"streamed_ttft_s": statistics.median(r["ttft_s"] for r in runs),
            "streamed_decode_tokens_per_s": statistics.median(rates),
            "streamed_runs": [{"ttft_s": r["ttft_s"], "decode_tokens_per_s": v} for r, v in zip(runs, rates)]}


def serve_row(results: list, launches: dict, write_s: float, load_s: float) -> dict:
    """Check the single-sequence serve's requests and launch counts; emit its line."""
    for name, r in zip(SERVE_KINDS, results):
        check(r["status"] == 200, f"{name} request: HTTP {r['status']}")
        check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"{name} request: empty or short completion")
        check(name != "streamed" or r["content"] == results[0]["content"],
              "streamed content differs from the non-streamed")
    n_prefill = len(results)
    # every decode step runs the 16 layers; a chunk dispatched past the
    # budget never happens (widths are capped by max_tokens)
    decode_steps = sum(r["tokens"] - 1 for r in results)
    check(launches["flash_prefill"] == LAYERS * n_prefill,
          f"prefill launches {launches['flash_prefill']} != {LAYERS} x {n_prefill} prefills")
    check(launches["flash_decode"] == LAYERS * decode_steps,
          f"decode launches {launches['flash_decode']} != {LAYERS} x {decode_steps} steps")
    row = {
        "phase": "serve", "gpu": gpu_line(), "model": "Llama-3.2-1B (synthetic bf16 weights, seed 0)",
        "checkpoint_write_s": write_s, "load_s": load_s, "launches": launches,
        "prefills": n_prefill, "decode_steps": decode_steps,
        "requests": [
            {"kind": k, "status": r["status"], "completion_tokens": r["tokens"], "s": r["s"],
             "tokens_per_s": r["tokens"] / r["s"], "content_head": r["content"][:40]}
            for k, r in zip(SERVE_KINDS, results)
        ],
        **streamed_rates(results),
    }
    emit(row)
    return row


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str) -> dict:
    return json.loads(urllib.request.urlopen(url, timeout=10).read())


def _post_json(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


async def _drive_ring(args: Namespace, model_dir: str, bodies: list, shard_urls: list) -> tuple:
    """The API node in this process in ring mode: prepare the manual
    topology, fan the load out to the shards, send `bodies` in order;
    returns (results, load seconds, each shard's /health after the first
    request, which warms the shards up)."""
    from dnet_tpu_torch.api.server import serve_async

    loop = asyncio.get_running_loop()
    server = asyncio.ensure_future(serve_async(args))
    base = f"http://127.0.0.1:{args.http_port}"
    t0 = time.perf_counter()
    try:
        while True:
            check(not server.done(), "ring API exited during start-up")
            try:
                await loop.run_in_executor(None, _get, base + "/health")
                break
            except OSError:
                check(time.perf_counter() - t0 < 120, "ring API not up within 120 s")
                await asyncio.sleep(0.3)
        topo = await loop.run_in_executor(None, _post_json, base + "/v1/prepare_topology_manual", {
            "model": model_dir,
            "assignments": [{"instance": f"s{i}", "layers": ls} for i, ls in enumerate(RING_LAYERS)],
        })
        check([a["next_instance"] for a in topo["topology"]["assignments"]] == ["s1", "s0"], f"ring {topo}")
        t_load = time.perf_counter()
        await loop.run_in_executor(None, _post_json, base + "/v1/load_model", {"model": model_dir})
        load_s = time.perf_counter() - t_load
        results, warm = [], None
        for body in bodies:
            results.append(await loop.run_in_executor(None, _post, base + "/v1/chat/completions", body))
            if warm is None:
                warm = [await loop.run_in_executor(None, _get, u + "/health") for u in shard_urls]
    finally:
        if not server.done():
            signal.raise_signal(signal.SIGTERM)  # the server's own shutdown path
        await server
    return results, load_s, warm


def _ring_pass(model_dir: str, codec: str, bodies: list, logdir: str) -> tuple:
    """Start the two shard processes on the card, serve `bodies` through
    them with the hop codec `codec`, read each shard's /health, and stop
    the shards; returns (results, [s0 health, s1 health], load seconds,
    the /health pair after the first request)."""
    env = dict(os.environ, DNET_WIRE_CODEC=codec, **RING_ENV)
    shards = [(f"s{i}", _free_port(), _free_port()) for i in range(len(RING_LAYERS))]
    hostfile = os.path.join(logdir, f"hostfile-{codec}")
    with open(hostfile, "w") as f:
        f.writelines(f"{n} 127.0.0.1 {h} {g}\n" for n, h, g in shards)
    procs, logs = [], []
    try:
        for name, http, grpc_port in shards:
            logs.append(os.path.join(logdir, f"shard-{codec}-{name}.log"))
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "dnet_tpu_torch.cli.shard", "--host", "127.0.0.1",
                     "--http-port", str(http), "--grpc-port", str(grpc_port), "--shard-name", name,
                     "--device", "cuda"],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        for (name, http, _), proc in zip(shards, procs):
            while True:
                check(proc.poll() is None, f"shard {name} exited with {proc.returncode}")
                try:
                    health = _get(f"http://127.0.0.1:{http}/health")
                    break
                except OSError:
                    check(time.perf_counter() - t0 < 120, f"shard {name} not up within 120 s")
                    time.sleep(0.3)
            # a fresh process: every launch count starts at 0
            check(not any(health["kernels"].values()), f"shard {name} counts not 0: {health['kernels']}")
        args = Namespace(
            host="127.0.0.1", http_port=_free_port(), grpc_port=_free_port(), hostfile=hostfile, model="",
            models_dir="", device="cuda", max_seq_len=S, param_dtype="bfloat16", max_concurrent=8,
            request_timeout_s=600.0,
        )
        with environ({"DNET_WIRE_CODEC": codec, **RING_ENV}):  # the API resolves the hop codec
            urls = [f"http://127.0.0.1:{http}" for _, http, _ in shards]
            results, load_s, warm = asyncio.run(_drive_ring(args, model_dir, bodies, urls))
        healths = [_get(u + "/health") for u in urls]
    except Exception:
        for path in logs:
            with open(path) as f:
                print(f"--- {path} ---\n{f.read()[-4000:]}", file=sys.stderr)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return results, healths, load_s, warm


def _steady(after: dict, before: dict, requests: list) -> dict:
    """Per-frame host times on one shard over `requests` (all but the
    first, warm-up request): its compute thread's time per frame, and the
    hop encode and decode per single-row hop and per prompt frame."""
    frames = after["compute"]["frames"] - before["compute"]["frames"]
    hops = sum(r["tokens"] - 1 for r in requests)
    w = {k: after["wire"][k] - before["wire"][k] for k in after["wire"]}
    return {"compute_ms_per_frame": (after["compute"]["ms"] - before["compute"]["ms"]) / frames,
            "hop_encode_ms": w["hop_encode_ms"] / hops, "hop_decode_ms": w["hop_decode_ms"] / hops,
            "prompt_encode_ms": w["prompt_encode_ms"] / len(requests),
            "prompt_decode_ms": w["prompt_decode_ms"] / len(requests)}


def phase_ring_serve(model_dir: str, bodies: list, serve_results: list, served: dict, long_body: dict) -> dict:
    """The checkpoint served as a two-shard ring, lossless then qsparse8;
    returns the qsparse8 pass's column-kernel launches."""
    greedy, sampled = serve_results[0], serve_results[2]
    out = {}
    for codec, reqs in (("lossless", bodies), ("qsparse8", bodies + [long_body])):
        results, (h0, h1), load_s, warm = _ring_pass(model_dir, codec, reqs, os.path.dirname(model_dir))
        for i, r in enumerate(results):
            check(r["status"] == 200, f"ring {codec} request {i}: HTTP {r['status']}")
            check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"ring {codec} request {i}: {r['tokens']} tokens")
        for k, r in zip(SERVE_KINDS, results):
            check(k != "streamed" or r["content"] == results[0]["content"],
                  f"ring {codec}: streamed differs from non-streamed")
        if codec == "lossless":
            check(results[0]["content"] == greedy["content"], "ring greedy text differs from the serve phase's")
            check(results[2]["content"] == sampled["content"], "ring seeded sampled text differs from the serve phase's")
        k0, k1, w0, w1 = h0["kernels"], h1["kernels"], h0["wire"], h1["wire"]
        steps = sum(r["tokens"] for r in results)  # one hidden frame per generated token
        n_layers = len(RING_LAYERS[0])
        check(w0["frames_encoded"] == w1["frames_decoded"] == steps, f"ring {codec} hidden frames {w0} {w1}")
        check(w0["bytes_encoded"] == w1["bytes_decoded"], f"ring {codec} hidden bytes {w0} {w1}")
        for k in (k0, k1):
            check(k["flash_prefill"] == n_layers * len(results), f"ring {codec} prefill launches {k}")
            check(k["flash_decode"] == n_layers * (steps - len(results)), f"ring {codec} decode launches {k}")
        if codec == "qsparse8":
            check(k0["column_sq_norms"] == k0["gather_columns"] == w0["frames_encoded"],
                  f"s0 column kernel launches {k0} != encoded frames {w0['frames_encoded']}")
            check(k1["dequant_scatter_columns"] == w1["frames_decoded"],
                  f"s1 dequant_scatter launches {k1} != decoded frames {w1['frames_decoded']}")
            check(k1["column_sq_norms"] == k1["gather_columns"] == k0["dequant_scatter_columns"] == 0,
                  "column kernels launched on the wrong shard")
        else:
            check(not any(k[n] for k in (k0, k1) for n in ("column_sq_norms", "gather_columns",
                                                           "dequant_scatter_columns")),
                  "a column kernel launched under the lossless codec")
        row = {
            "phase": "ring_serve", "codec": codec, "gpu": gpu_line(),
            "transport": "real gRPC on 127.0.0.1: one process per shard, the API node in this process",
            "layers": [f"{ls[0]}-{ls[-1]}" for ls in RING_LAYERS], "load_s": load_s,
            "decode_hop_bytes": w0["decode_hop_bytes"], "wire": {"s0": w0, "s1": w1},
            # steady-state host times per frame on each shard (s0 encodes,
            # s1 decodes), the warm-up request left out
            "steady": {f"s{i}": _steady(h, w, results[1:]) for i, (h, w) in enumerate(zip((h0, h1), warm))},
            "launches": {"s0": k0, "s1": k1}, "decode_steps": steps - len(results),
            "requests": [
                {"kind": k, "status": r["status"], "completion_tokens": r["tokens"], "s": r["s"],
                 "content_head": r["content"][:40]}
                for k, r in zip(SERVE_KINDS + ("long_prompt_streamed",), results)
            ],
            **streamed_rates(results),
            "single_process": {k: served[k] for k in ("streamed_ttft_s", "streamed_decode_tokens_per_s")},
        }
        if codec == "qsparse8":
            long = results[-1]
            row["long_prompt"] = {"prompt_tokens": BATCH_PROMPT_TOKENS[-1], "ttft_s": long["ttft_s"],
                                  "decode_tokens_per_s": (long["tokens"] - 1) / max(long["decode_s"], 1e-9)}
            out = {"column_sq_norms": k0["column_sq_norms"], "gather_columns": k0["gather_columns"],
                   "dequant_scatter_columns": k1["dequant_scatter_columns"]}
        emit(row)
    return out


def phase_batch_serve(model_dir: str, port: int, batch_step: dict) -> dict:
    """The checkpoint served with continuous batching: 8 concurrent streamed
    requests of ragged prompt lengths share the batched decode step."""
    contents = _batch_prompts()
    args = Namespace(
        host="127.0.0.1", http_port=port, model=model_dir, models_dir="", device="cuda",
        max_seq_len=S, param_dtype="bfloat16", max_concurrent=BATCH_SLOTS, request_timeout_s=600.0,
        batch_slots=BATCH_SLOTS,
    )
    bodies = [
        {"model": "llama-3.2-1b-synthetic", "max_tokens": MAX_TOKENS, "temperature": 0, "stream": True,
         "messages": [{"role": "user", "content": c}], "logit_bias": TEXT_BIAS}
        for c in contents
    ]
    bodies[3] = dict(bodies[3], temperature=0.8, top_p=0.95, seed=4321)
    with environ(PAGED_ENV):
        results, launches, load_s, health = asyncio.run(_drive(args, bodies, concurrent=True))
    for i, r in enumerate(results):
        check(r["status"] == 200, f"batched request {i}: HTTP {r['status']}")
        check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"batched request {i}: {r['tokens']} tokens")
    engine = health["engine"]
    steps = engine["decode_steps"]
    chunks = sum(-(-n // PREFILL_CHUNK) for n in BATCH_PROMPT_TOKENS)
    check(steps > 0 and launches["paged_attend"] == LAYERS * steps,
          f"paged launches {launches['paged_attend']} != {LAYERS} x {steps} batched decode steps")
    check(launches["flash_decode"] == 0, f"{launches['flash_decode']} single-sequence decode launches")
    check(launches["flash_prefill"] == LAYERS * chunks,
          f"prefill launches {launches['flash_prefill']} != {LAYERS} x {chunks} prompt chunks")
    check(engine["active"] == 0 and engine["kv_blocks_used"] == 0, f"slots or blocks leaked: {engine}")
    t_start = min(r["t0"] for r in results)
    t_first = min(r["t_first"] for r in results)
    t_end = max(r["t_end"] for r in results)
    tokens = sum(r["tokens"] for r in results)
    row = {
        "phase": "batch_serve", "gpu": gpu_line(), "model": "Llama-3.2-1B (synthetic bf16 weights, seed 0)",
        "batch_slots": BATCH_SLOTS, "block_tokens": BT, "pool_blocks": engine["kv_pool_blocks"],
        "load_s": load_s, "launches": launches, "decode_steps": steps, "prefill_chunks": chunks,
        "kv_blocks_peak": engine["kv_blocks_peak"],
        "burst_s": t_end - t_start, "completion_tokens": tokens,
        "aggregate_tokens_per_s": tokens / (t_end - t_start),
        "aggregate_decode_tokens_per_s": (tokens - len(results)) / (t_end - t_first),
        "requests": [
            {"prompt_tokens": n, "sampled": i == 3, "status": r["status"], "completion_tokens": r["tokens"],
             "ttft_s": r["ttft_s"], "gap_median_ms": r["gap_median_s"] * 1e3, "gap_max_ms": r["gap_max_s"] * 1e3,
             "content_head": r["content"][:24]}
            for i, (n, r) in enumerate(zip(BATCH_PROMPT_TOKENS, results))
        ],
        "step_at_8_lanes": {k: batch_step[k] for k in ("wall_ms", "host_issue_ms", "device_busy_ms",
                                                       "device_idle_share", "paged_kernel_ms")},
    }
    emit(row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from dnet_tpu_torch.core.engine import bucket_length
    from dnet_tpu_torch.kernels.build import build_all
    from dnet_tpu_torch.utils.tokenizer import ByteTokenizer

    card = gpu_line()
    t0 = time.perf_counter()
    build_all()
    emit({"phase": "device", "gpu": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "kernel_build_s": time.perf_counter() - t0})

    prompt_text = "Write one line about GPUs."
    tok = ByteTokenizer()
    n_prompt = len(tok.encode(tok.apply_chat_template([{"role": "user", "content": prompt_text}])))
    main_path = phase_kernels(bucket_length(n_prompt), n_prompt + MAX_TOKENS - 2)
    # the batched path's mix: every batch_serve lane half-way through its output
    main_path["paged_attend"] = phase_paged_kernels([n + MAX_TOKENS // 2 for n in BATCH_PROMPT_TOKENS])
    # the ring's path: its decode hop (R=1, bf16) runs once per token
    main_path.update(phase_column_kernels())
    phase_codec_host()
    phase_parity()
    phase_batch_parity()
    served, batched, ring = phase_serve(prompt_text, n_prompt)

    # each kernel with its launches on its own path: the single-sequence
    # serve for the dense prefill and decode kernels, the batched serve for
    # the paged one (whose prompts also went through the prefill kernel),
    # the qsparse8 ring for the column kernels (counted in the shards)
    sources = {
        "flash_prefill": ("dnet_tpu_torch/csrc/flash_prefill.cu", "dnet_tpu/ops/flash_attention.py:38", served),
        "flash_decode": ("dnet_tpu_torch/csrc/flash_decode.cu", "dnet_tpu/ops/flash_decode.py:50", served),
        "paged_attend": ("dnet_tpu_torch/csrc/paged_attention.cu", "dnet_tpu/ops/paged_attention.py:92", batched),
        "column_sq_norms": ("dnet_tpu_torch/csrc/column_ops.cu", "dnet_tpu/compression/ops.py:24",
                            {"launches": ring}),
        "gather_columns": ("dnet_tpu_torch/csrc/column_ops.cu", "dnet_tpu/compression/ops.py:81",
                           {"launches": ring}),
        "dequant_scatter_columns": ("dnet_tpu_torch/csrc/column_ops.cu", "dnet_tpu/compression/ops.py:81",
                                    {"launches": ring}),
    }
    for name, (_, _, path) in sources.items():
        check(path["launches"][name] > 0, f"{name} never launched on its path")
    check(batched["launches"]["flash_prefill"] > 0, "flash_prefill never launched on the batched path")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path["launches"][name], "max_abs_err": main_path[name]["max_err"],
         "ms": main_path[name]["kernel_ms"], "plain_ms": main_path[name]["plain_ms"],
         "bound_ms": main_path[name]["bound_ms"], "bound_by": main_path[name]["bound_by"],
         "library_ms": main_path[name]["library_ms"]}
        for name, (src, rep, path) in sources.items()
    ]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
