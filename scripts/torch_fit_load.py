"""Cold and warm fit loads of a Llama-3.2-1B checkpoint through the port's
checkpoint reader, for one or more copies of the port.

Writes the checkpoint once (Llama-3.2-1B's published widths, all 16 layers
or the first `--layers`, bf16, N(0, 0.02) weights from seed 0, drawn on the card when there is one),
then, for each tree given (a directory holding a `dnet_tpu_torch` package),
reads it in a fresh process the way a fit `LocalEngine` does
(`Checkpoint.load_layer_raw` for each layer, then `load_edge_raw`), in the
order given and then in reverse.  Each process reads twice:

  cold  the checkpoint's own pages are dropped from the page cache first
        (fsync, then posix_fadvise(POSIX_FADV_DONTNEED) on its files; no
        machine-wide cache is touched), and mincore reports the share of
        the file still resident before the read
  warm  the same read again at once

    python scripts/torch_fit_load.py --dir build/fit_load PARENT_TREE CHANGED_TREE

Prints one JSON line a read (tree, mode, seconds, GB/s, resident share
before it, the directory's file system) and a summary line last.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

CHILD = r"""
import ctypes, json, os, sys, time
from pathlib import Path
from dnet_tpu_torch.utils.checkpoint import Checkpoint

libc = ctypes.CDLL("libc.so.6", use_errno=True)
libc.mmap.restype = ctypes.c_void_p
libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long]
libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p]
PAGE = os.sysconf("SC_PAGESIZE")


def resident(path):
    # pages of the file in the page cache, through a mapping of our own
    size = os.path.getsize(path)
    fd = os.open(path, os.O_RDONLY)
    try:
        addr = libc.mmap(None, size, 1, 1, fd, 0)  # PROT_READ, MAP_SHARED
        vec = ctypes.create_string_buffer((size + PAGE - 1) // PAGE)
        if libc.mincore(addr, size, vec) != 0:
            raise OSError(ctypes.get_errno(), "mincore")
        libc.munmap(addr, size)
    finally:
        os.close(fd)
    return sum(b & 1 for b in vec.raw), (size + PAGE - 1) // PAGE


def drop(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


tree, ckpt_dir = sys.argv[1], Path(sys.argv[2])
files = sorted(ckpt_dir.glob("*.safetensors"))
nbytes = sum(f.stat().st_size for f in files)
ck = Checkpoint(ckpt_dir)  # the native store builds here, untimed, where the tree has one
for mode in ("cold", "warm"):
    if mode == "cold":
        for f in files:
            drop(f)
    pages = [resident(f) for f in files]
    share = sum(p[0] for p in pages) / sum(p[1] for p in pages)
    t = time.perf_counter()
    for a in range(ck.num_layers):
        ck.load_layer_raw(a)
    ck.load_edge_raw()
    s = time.perf_counter() - t
    print(json.dumps({"tree": tree, "mode": mode, "s": s, "gb_per_s": nbytes / s / 1e9, "bytes": nbytes,
                      "resident_share_before": share}), flush=True)
"""


def write_checkpoint(out: Path, layers: int) -> None:
    sys.path.insert(0, str(REPO))
    import torch

    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.models.convert import hf_tensors
    from dnet_tpu_torch.utils.checkpoint import save_checkpoint
    from dnet_tpu_torch.utils.random_init import LLAMA_3_2_1B_CONFIG, random_llama_params

    raw = dict(LLAMA_3_2_1B_CONFIG, num_hidden_layers=layers or LLAMA_3_2_1B_CONFIG["num_hidden_layers"])
    cfg = ModelConfig.from_hf(raw)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    window, edge = random_llama_params(cfg, range(cfg.num_hidden_layers), dev, torch.bfloat16, seed=0)
    save_checkpoint(out, raw, hf_tensors(window, edge))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="directories each holding a dnet_tpu_torch package")
    ap.add_argument("--dir", default="build/fit_load", help="where the checkpoint is written (removed after)")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers (0: all 16)")
    args = ap.parse_args()
    root = Path(args.dir).resolve()
    ckpt = root / "llama-3.2-1b-synthetic"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        write_checkpoint(ckpt, args.layers)
        fs = subprocess.run(["stat", "-f", "-c", "%T", str(root)], capture_output=True, text=True).stdout.strip()
        rows = []
        for tree in args.trees + args.trees[::-1]:
            env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
            proc = subprocess.run([sys.executable, "-c", CHILD, tree, str(ckpt)], env=env, capture_output=True,
                                  text=True, timeout=600)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr)
                return 1
            for line in proc.stdout.splitlines():
                row = dict(json.loads(line), fs=fs)
                print(json.dumps(row), flush=True)
                rows.append(row)
        summary = {t: {m: sorted(r["s"] for r in rows if r["tree"] == t and r["mode"] == m) for m in ("cold", "warm")}
                   for t in args.trees}
        print(json.dumps({"summary_s": summary, "fs": fs}))
        return 0
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
