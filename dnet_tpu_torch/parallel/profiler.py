"""Device profiling: the capability microbenchmarks behind the solver.

Counterpart of dnet_tpu/parallel/profiler.py `profile_device_quick`, with
the same probes and the same keys: achieved bf16 matmul FLOP/s (N = 2048,
eight chained products), device-memory read bandwidth (a reduction over
64 MB of bf16, eight times), the host-to-device copy rate (32 MB, four
times), the device's memory, the host's RAM, and how many devices this
node puts behind one ring position.  The probes are measurements, not
kernels: plain `torch.matmul` / `sum` / `to`.

The reference profiles in a child process because JAX holds its device
exclusively.  A CUDA context has no such lock, so the port profiles in the
shard process itself, on the shard's own device (`profile_device`, run off
the event loop by the shard's POST /profile).  A shard serves from one
device, so `local_device_count` is 1.  On the CPU there is no device
memory: `hbm_bytes` and `hbm_in_use` read 0, as the reference's CPU
backend reports them (and the solver then takes every layer as fitting).
A probe that fails raises: a profile is never made up.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Union

import numpy as np
import torch

MATMUL_N = 2048
ITERS = 8
REDUCE_BYTES = 64 * 1024 * 1024
H2D_BYTES = 32 * 1024 * 1024
H2D_ITERS = 4


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ram_bytes() -> int:
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def profile_device(device: Optional[Union[str, torch.device]] = None) -> dict:
    """One device's profile, the reference's keys (see the module doc)."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    # matmul FLOP/s (bf16), the first product warming up
    a = torch.ones((MATMUL_N, MATMUL_N), dtype=torch.bfloat16, device=dev)
    b = torch.ones((MATMUL_N, MATMUL_N), dtype=torch.bfloat16, device=dev)
    torch.matmul(a, b)
    _sync(dev)
    t0 = time.perf_counter()
    out = a
    for _ in range(ITERS):
        out = torch.matmul(out, b)
    _sync(dev)
    flops = 2 * MATMUL_N**3 * ITERS / (time.perf_counter() - t0)

    # device-memory read bandwidth: an f32 sum over 64 MB of bf16
    big = torch.ones((REDUCE_BYTES // 2,), dtype=torch.bfloat16, device=dev)
    big.sum(dtype=torch.float32)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        big.sum(dtype=torch.float32)
        _sync(dev)
    hbm_bw = REDUCE_BYTES * ITERS / (time.perf_counter() - t0)

    # host -> device copy rate from plain (pageable) host memory
    host = torch.from_numpy(np.ones((H2D_BYTES,), dtype=np.uint8))
    host.to(dev, copy=True)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(H2D_ITERS):
        host.to(dev, copy=True)
        _sync(dev)
    h2d = H2D_BYTES * H2D_ITERS / (time.perf_counter() - t0)

    free = total = 0
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
    del a, b, out, big
    return {
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "flops_bf16": flops,
        "hbm_bw": hbm_bw,
        "host_to_hbm_bw": h2d,
        "host_ram_bytes": host_ram_bytes(),
        "local_device_count": 1,
        "hbm_bytes": int(total),
        "hbm_in_use": int(total - free),
    }
