"""Kernel-build tracking, device-memory gauges and the device fence.

Counterpart of dnet_tpu/obs/jit.py.  The port has no `jax.jit`: its one
compile step is the build (or cached load) of a CUDA source at its first
use in a process (kernels/build.py `load`).  `count_build` records it under
the reference's families, `dnet_jit_compiles_total{fn}` with `fn` the
source's stem (obs/phases.py KERNEL_SOURCES, in place of the reference's
JIT_FNS) and `dnet_jit_compile_ms` (nvcc, or the cached library's load).

`update_device_mem_gauges()` publishes `dnet_device_mem_bytes{kind}` from
the CUDA caching allocator: `in_use` and `peak` are its allocated bytes
(current and peak) and `limit` the card's total memory
(`torch.cuda.mem_get_info`), summed over the cards this process has
initialised.  On the CPU, or before CUDA is up, it reports nothing and
returns False, as the reference does where PJRT has no stats; a scrape
never initialises CUDA.

`fence(device)` is the one device synchronisation the instrumentation
makes: a `torch.cuda.synchronize` of the engine's card, so that a phase's
wall time covers its kernels.  Call sites call it only when
`obs_enabled()` (or a DNET_OBS_SYNC_* knob) asks; `fence_calls()` counts
the calls, so a test can show the served path makes none with obs off.
"""

from __future__ import annotations

import torch

from dnet_tpu_torch.obs.phases import DEVICE_MEM_KINDS, KERNEL_SOURCES

_fences = 0


def count_build(name: str, ms: float) -> None:
    """One build or cached load of csrc/<name> at its first use."""
    from dnet_tpu_torch.obs import metric

    if name not in KERNEL_SOURCES:
        raise ValueError(f"kernel source {name!r} is not declared in dnet_tpu_torch.obs.phases.KERNEL_SOURCES")
    metric("dnet_jit_compiles_total").labels(fn=name).inc()
    metric("dnet_jit_compile_ms").observe(ms)


def fence(device) -> None:
    """Wait for every kernel queued on `device` (a CUDA card; nothing to
    wait for on the CPU, where the call is still counted)."""
    global _fences
    _fences += 1
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fence_calls() -> int:
    """Fences made in this process."""
    return _fences


def update_device_mem_gauges() -> bool:
    """Refresh dnet_device_mem_bytes{kind} from the caching allocator of
    every card this process allocated on.  False (gauges untouched) on the
    CPU or before CUDA is initialised."""
    from dnet_tpu_torch.obs import metric

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return False
    totals = dict.fromkeys(DEVICE_MEM_KINDS, 0.0)
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats.get("allocated_bytes.all.peak", 0):
            continue  # a card this process never allocated on: no context made
        totals["in_use"] += float(stats.get("allocated_bytes.all.current", 0))
        totals["peak"] += float(stats.get("allocated_bytes.all.peak", 0))
        totals["limit"] += float(torch.cuda.mem_get_info(i)[1])
    if totals["limit"] <= 0:
        return False
    fam = metric("dnet_device_mem_bytes")
    for kind, v in totals.items():
        fam.labels(kind=kind).set(v)
    return True
