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
           loopback: a greedy chat completion, the same request streamed
           (equal content), and a seeded sampled one; every attention call
           on that path must have gone through the kernels.
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

    tmp = tempfile.mkdtemp(prefix="dnet-torch-smoke-")
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
        results, launches, load_s, _ = asyncio.run(
            _drive(args, [chat, dict(chat, stream=True), sampled]))
        row = serve_row(results, launches, write_s, load_s)
        batched = phase_batch_serve(tmp, port, batch_step)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return row, batched


def serve_row(results: list, launches: dict, write_s: float, load_s: float) -> dict:
    """Check the single-sequence serve's requests and launch counts; emit its line."""
    greedy, streamed, sample = results
    for name, r in zip(("greedy", "streamed", "sampled"), results):
        check(r["status"] == 200, f"{name} request: HTTP {r['status']}")
        check(bool(r["content"]) and r["tokens"] == MAX_TOKENS, f"{name} request: empty or short completion")
    check(streamed["content"] == greedy["content"], "streamed content differs from the non-streamed")
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
            for k, r in zip(("greedy", "streamed", "sampled"), results)
        ],
        "streamed_ttft_s": streamed["ttft_s"],
        "streamed_decode_tokens_per_s": (streamed["tokens"] - 1) / max(streamed["decode_s"], 1e-9),
    }
    emit(row)
    return row


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
    phase_parity()
    phase_batch_parity()
    served, batched = phase_serve(prompt_text, n_prompt)

    # each kernel with its launches on its own path: the single-sequence
    # serve for the dense prefill and decode kernels, the batched serve for
    # the paged one (whose prompts also went through the prefill kernel)
    sources = {
        "flash_prefill": ("dnet_tpu_torch/csrc/flash_prefill.cu", "dnet_tpu/ops/flash_attention.py:38", served),
        "flash_decode": ("dnet_tpu_torch/csrc/flash_decode.cu", "dnet_tpu/ops/flash_decode.py:50", served),
        "paged_attend": ("dnet_tpu_torch/csrc/paged_attention.cu", "dnet_tpu/ops/paged_attention.py:92", batched),
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
