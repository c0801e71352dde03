#!/usr/bin/env python3
"""Serve the same synthetic checkpoint from two or more copies of the
PyTorch port, in turns, and compare their streamed rates on one card.

    python scripts/torch_serve_ab.py --dir build/serve_ab TREE_A TREE_B [...]

Each TREE is a directory holding a `dnet_tpu_torch` package (the checkout
itself, or one unpacked with `git archive <commit> | tar -x -C TREE`).  The
script writes full-width Llama-3.2-1B with random bf16 weights (seed 0)
once under --dir, then for each round serves it from each tree in a fresh
process (`dnet_tpu_torch.api.server.serve_async`, default settings: obs
off) and sends --requests streamed greedy requests of --tokens tokens one
after another; the trees' order alternates round by round (A, B, B, A,
...).  Prints one JSON line per serve (the tree, its median decode rate and
TTFT) and a summary line per tree, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PROMPT = "Write one line about GPUs."
# printable ASCII favoured so the random weights' completions are text
TEXT_BIAS = {str(t): 100.0 for t in range(32, 127)}


def _gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def _write_checkpoint(path: Path) -> None:
    import torch

    from dnet_tpu_torch.models import ModelConfig
    from dnet_tpu_torch.models.convert import hf_tensors
    from dnet_tpu_torch.utils.checkpoint import save_checkpoint
    from dnet_tpu_torch.utils.random_init import LLAMA_3_2_1B_CONFIG, random_llama_params

    cfg = ModelConfig.from_hf(LLAMA_3_2_1B_CONFIG)
    window, edge = random_llama_params(cfg, range(cfg.num_hidden_layers), torch.device("cuda"), torch.bfloat16, seed=0)
    save_checkpoint(str(path), LLAMA_3_2_1B_CONFIG, hf_tensors(window, edge))


def _stream(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    t_first = None
    tokens = 0
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: {"):
                continue
            ev = json.loads(line[len("data: "):])
            if any(c["delta"].get("content") for c in ev["choices"]):
                t_first = t_first or time.perf_counter()
            if ev.get("usage"):
                tokens = ev["usage"]["completion_tokens"]
    t_end = time.perf_counter()
    return {"ttft_s": (t_first or t_end) - t0, "decode_tokens_per_s": (tokens - 1) / max(t_end - (t_first or t_end), 1e-9),
            "tokens": tokens}


async def _serve(ckpt: str, port: int, requests: int, tokens: int) -> list:
    """In the child: serve `ckpt` with this tree's port and time the requests."""
    from argparse import Namespace

    from dnet_tpu_torch.api.server import serve_async

    args = Namespace(host="127.0.0.1", http_port=port, model=ckpt, models_dir="", device="cuda", max_seq_len=4096,
                     param_dtype="bfloat16", max_concurrent=8, request_timeout_s=600.0)
    loop = asyncio.get_running_loop()
    server = asyncio.ensure_future(serve_async(args))
    base = f"http://127.0.0.1:{port}"
    def health() -> dict:
        with urllib.request.urlopen(base + "/health", timeout=5) as r:
            return json.loads(r.read())

    while True:
        if server.done():
            raise RuntimeError("server exited during start-up")
        try:
            # off the loop: the server answers on this same loop
            if (await loop.run_in_executor(None, health)).get("model"):
                break
        except OSError:
            pass
        await asyncio.sleep(0.5)
    body = {"model": "m", "max_tokens": tokens, "temperature": 0, "stream": True, "logit_bias": TEXT_BIAS,
            "messages": [{"role": "user", "content": PROMPT}]}
    try:
        await loop.run_in_executor(None, _stream, base + "/v1/chat/completions", dict(body, max_tokens=8))  # warm-up
        return [await loop.run_in_executor(None, _stream, base + "/v1/chat/completions", body) for _ in range(requests)]
    finally:
        import signal

        signal.raise_signal(signal.SIGTERM)
        await server


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--dir", default="build/serve_ab", help="where the synthetic checkpoint is written")
    ap.add_argument("--rounds", type=int, default=2, help="rounds; each serves every tree once")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--child", nargs=2, metavar=("CKPT", "PORT"), help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        results = asyncio.run(_serve(a.child[0], int(a.child[1]), a.requests, a.tokens))
        print(json.dumps(results), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(a.trees) < 2:
        ap.error("give two or more trees")
    ckpt = Path(a.dir).resolve() / "llama-3.2-1b-synthetic"
    sys.path.insert(0, str(REPO))  # the checkpoint is written by this checkout's port
    if not (ckpt / "config.json").is_file():
        ckpt.mkdir(parents=True, exist_ok=True)
        _write_checkpoint(ckpt)
    card = _gpu_line()
    runs = {t: [] for t in a.trees}
    for rnd in range(a.rounds):
        order = a.trees if rnd % 2 == 0 else list(reversed(a.trees))
        for tree in order:
            root = Path(tree).resolve()
            import socket

            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            env = dict(os.environ, PYTHONPATH=str(root))
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--child", str(ckpt), str(port),
                 "--requests", str(a.requests), "--tokens", str(a.tokens)],
                cwd=str(root), env=env, capture_output=True, text=True,
            )
            if proc.returncode != 0:
                print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
                return 1
            results = json.loads(proc.stdout.strip().splitlines()[-1])
            row = {"round": rnd, "tree": tree, "gpu": card,
                   "decode_tokens_per_s": statistics.median(r["decode_tokens_per_s"] for r in results),
                   "ttft_s": statistics.median(r["ttft_s"] for r in results),
                   "tokens": [r["tokens"] for r in results]}
            runs[tree].append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"summary": {t: {"decode_tokens_per_s": [r["decode_tokens_per_s"] for r in rows],
                                      "ttft_s": [r["ttft_s"] for r in rows]} for t, rows in runs.items()},
                      "gpu": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
