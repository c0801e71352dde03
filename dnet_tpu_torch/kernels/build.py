"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC --split-compile=0

into `build/dnet_tpu_torch/<name>-<hash>.so` at the repository root (listed
in .gitignore), keyed by a hash of the sources and flags, so an edited
kernel rebuilds and an unchanged one loads in milliseconds.  The sources
expose a plain C interface (no PyTorch headers): a build takes seconds.
`build_all()` starts one nvcc per source, all at once.

A source's first load in a process counts as its compile step in
`dnet_jit_compiles_total{fn=<name>}` and `dnet_jit_compile_ms` (obs/jit.py).

Each C entry point returns `cudaGetLastError()` after its launch, and the
Python wrappers raise when it is not 0: a launch the driver refuses never
runs, and nothing else would report it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

from dnet_tpu_torch.obs.jit import count_build

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dnet_tpu_torch"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # optimise a source's kernels on every core: the decode kernel's many
    # instantiations take minutes on one
    "--split-compile=0",
)
# every kernel source; each builds into its own shared library
SOURCES = ("flash_prefill", "flash_decode", "paged_attention", "column_ops")
# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the port's "
            "kernels build from csrc/ at first use on a CUDA machine"
        )
    return found


def _library_path(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc_command(name: str, nvcc: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, one nvcc each, all
    started together; returns each library's path.  Raises on any failure
    with the compiler's output."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n, nvcc) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.is_file():
            continue
        # unique temporary name, renamed into place: a concurrent builder
        # never loads a half-written library
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        procs[n] = (
            subprocess.Popen(
                _nvcc_command(n, nvcc, tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
        )
    failures = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def ptxas_report(name: str) -> list:
    """Each kernel of csrc/<name>.cu as ptxas reports it: compiles the source
    to a cubin with `-Xptxas -v` (the library's flags otherwise) and returns
    one dict per kernel: its name (demangled with cu++filt where the toolkit
    has it), registers, spill stores and loads, stack frame and static
    shared memory in bytes.  Raises with the compiler's output on failure."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}.{os.getpid()}.ptxas.cubin"
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([nvcc, *flags, "-cubin", "-Xptxas", "-v", "-I", str(CSRC), "-o", str(out),
                           str(CSRC / f"{name}.cu")], capture_output=True, text=True)
    out.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v {name}.cu failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    kernels, cur = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = kernels.setdefault(m.group(1), {"mangled": m.group(1)})
            continue
        if cur is None:
            continue
        for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"), ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("spill_load_bytes", r"(\d+) bytes spill loads"), ("registers", r"Used (\d+) registers"),
                         ("static_smem_bytes", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                cur[key] = int(m.group(1))
    filt = Path(nvcc).with_name("cu++filt")
    names = list(kernels)
    if filt.is_file() and names:
        demangled = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
        if len(demangled) == len(names):
            for mangled, plain in zip(names, demangled):
                kernels[mangled]["name"] = plain
    return [{"name": k.pop("name", k["mangled"]), **k} for k in kernels.values()]


def build_all() -> Dict[str, Path]:
    """Build (if needed) and load every kernel library."""
    paths = build(SOURCES)
    for n in SOURCES:
        load(n)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
            count_build(name, (time.perf_counter() - t0) * 1000.0)
    return lib


def entry(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry point `symbol` of csrc/<name>.cu with its argument types
    declared (every pointer and the stream as c_void_p: ctypes would pass
    an undeclared Python int as a 32-bit int and cut the pointer) and an
    int return, the launch's cudaGetLastError()."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


_COUNT_LOCK = threading.Lock()
_SCOPE = threading.local()


def count_launch(fn, counter: str = "launches") -> None:
    """One launch on the wrapper's counter `counter`, and in this thread's
    open `launch_scope`, if any.  Under the wire pipeline the compute
    thread and the event loop (the receive side's dequant-scatter) both
    launch kernels, so the increment holds a lock."""
    with _COUNT_LOCK:
        setattr(fn, counter, getattr(fn, counter) + 1)
        into = getattr(_SCOPE, "into", None)
        if into is not None:
            into[(fn, counter)] = into.get((fn, counter), 0) + 1


@contextlib.contextmanager
def launch_scope(into: dict):
    """Count this thread's launches within the block in `into` too, by
    (wrapper, counter) (kernels/__init__.py `scope_counts` names them):
    the mesh engine's per-stage launches, one scope a stage's run."""
    _SCOPE.into = into
    try:
        yield
    finally:
        _SCOPE.into = None


def reset_counter(fn, counter: str = "launches") -> None:
    with _COUNT_LOCK:
        setattr(fn, counter, 0)


def current_stream_handle(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda_tensors(
    op: str, dtype: torch.dtype, device: Optional[torch.device] = None, **tensors: torch.Tensor
) -> None:
    """Raise ValueError unless every tensor is a contiguous CUDA tensor of
    `dtype` on one device (`device`, when given) with a 16-byte-aligned base
    (the kernels read rows as 16-byte vectors)."""
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{op}: {name} is on {t.device}, expected a CUDA tensor")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, the others on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{op}: {name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} is not 16-byte aligned")
