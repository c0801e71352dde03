"""The device kernels of one traced call, each in a fresh Python process.

tests/test_torch_kernels_gpu.py holds every one-kernel-a-call case to what
torch.profiler traces.  Late in a long test process the profiler was seen to
trace no device kernel at all, a different few cases in every full run.  So
each case is traced here in a new process (`trace_all` runs several at once,
each process tracing only its own calls): it makes the case's inputs from
the same seed as the test (the test module's TRACE_CASES), warms the call
up, traces it under a profiler session of its own, synchronised inside the
session, and prints the device kernels' names as JSON; the test asserts on
them.  The kernels are built already (the build directory keys them by
source), so the process only loads them.

    python tests/torch_gpu_trace.py <case> '<json list of arguments>'

It is run by path, with the repository's root on PYTHONPATH, and imports
the test module by its own name: a machine may have another package named
`tests` installed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def trace_device_kernels(case: str, *args) -> dict:
    """{"kernels": [device kernel names], "counted": the case's counter
    across the traced call (None where it has none), "events": every event
    the session traced} for one call of TRACE_CASES[case](*args), traced in
    a fresh process."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), case, json.dumps(list(args))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"tracing {case}{args} failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    return json.loads(lines[-1])


def trace_all(cases, workers: int = 8) -> dict:
    """{(case, *args): trace_device_kernels(case, *args)} for every tuple in
    `cases`, `workers` processes at a time (each traces only its own
    calls)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as pool:
        futures = {key: pool.submit(trace_device_kernels, *key) for key in cases}
        return {key: f.result() for key, f in futures.items()}


def _trace(case: str, args: list) -> dict:
    import pytest
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from test_torch_kernels_gpu import TRACE_CASES

    gen = torch.Generator(device="cuda").manual_seed(0)
    with pytest.MonkeyPatch.context() as mp:
        call, counter = TRACE_CASES[case](gen, mp, *args)
        call()  # built, loaded and warm
        torch.cuda.synchronize()
        for _ in range(3):  # the profiler now and then drops a short call's record; it never invents one
            before = counter() if counter else None
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(0.002)  # the call well inside the traced window
                call()
                torch.cuda.synchronize()
                time.sleep(0.002)
            events = prof.events()
            kernels = [e.name for e in events if e.device_type == DeviceType.CUDA]
            if kernels:
                break
    return {"kernels": kernels, "counted": counter() - before if counter else None, "events": len(events)}


if __name__ == "__main__":
    print(json.dumps(_trace(sys.argv[1], json.loads(sys.argv[2]))), flush=True)
