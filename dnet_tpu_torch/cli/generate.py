"""`dnet-torch-generate`: offline batch generation on one GPU.

    python -m dnet_tpu_torch.cli.generate --model <dir> --prompts prompts.txt
    python -m dnet_tpu_torch.cli.generate --model <dir> --raw --max-tokens 32 < prompts.txt
    python -m dnet_tpu_torch.cli.generate --model <dir> --mesh sp=2    # KV over 2 sp ranks
    python -m dnet_tpu_torch.cli.generate --model <dir> --mesh pp=2 --spec 4    # 2 stages, prompt lookup
    python -m dnet_tpu_torch.cli.generate --model <dir> --spec 4 --draft <draft dir>

The counterpart of dnet_tpu/cli/generate.py (`dnet-generate`), over the
port's single-sequence engine, or its mesh engine for --mesh pp=P,sp=N
(pipeline stages of sequence-parallel ranks; --spec drafts there by prompt
lookup).  Input: one prompt per line (a text file, or - for stdin),
wrapped in the chat template unless --raw.  Output: one JSONL row
{"prompt", "text", "tokens", "tok_s"} per prompt.  Runs on CUDA unless
--device cpu is given.  Refused with exit 2, as the reference refuses
them: a model or draft model that is not found, --draft without --spec,
and --draft with --mesh; and, where the reference would serve and the port
does not yet: the tp / dp mesh axes and a multi-process pod
(DNET_MESH_NUM_PROCESSES > 1: the distributed runtime is ROADMAP A7).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from dnet_tpu_torch.config import api_settings, mesh_settings
from dnet_tpu_torch.utils.logger import setup_logger


def build_parser() -> argparse.ArgumentParser:
    s = api_settings()
    p = argparse.ArgumentParser(prog="dnet-torch-generate", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="checkpoint path or catalog id")
    p.add_argument("--prompts", default="-", help="file with one prompt per line (- = stdin)")
    p.add_argument("--output", default="-", help="JSONL output path (- = stdout)")
    p.add_argument("--max-tokens", type=int, default=128)
    p.add_argument("--max-seq", type=int, default=s.max_seq_len)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--param-dtype", default=s.param_dtype)
    p.add_argument("--mesh", default="", help="pipeline stages / sequence-parallel ranks, e.g. 'pp=2,sp=2'")
    p.add_argument("--raw", action="store_true", help="feed prompts verbatim (no chat template)")
    p.add_argument("--spec", type=int, default=0, metavar="L",
                   help="speculative decoding lookahead (greedy only; 0 = off) — works on the local engine and "
                        "on --mesh engines alike")
    p.add_argument("--draft", default="", metavar="MODEL",
                   help="draft MODEL for speculation (checkpoint path or catalog id; needs --spec; without it "
                        "drafts come from prompt lookup)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run there)")
    return p


def _refuse(message: str) -> int:
    print(message, file=sys.stderr)
    return 2


def _engine(args, model_dir, draft_dir):
    """The engine the arguments ask for, or an exit-2 message."""
    from dnet_tpu_torch.api.inference import EngineCapabilityError
    from dnet_tpu_torch.parallel.mesh import parse_mesh

    mesh = parse_mesh(args.mesh)
    if not mesh:
        from dnet_tpu_torch.core.engine import LocalEngine

        return LocalEngine(model_dir, max_seq=args.max_seq, param_dtype=args.param_dtype, device=args.device,
                           spec_lookahead=args.spec, draft_dir=draft_dir)
    if draft_dir is not None:
        return "--draft is local-engine only; mesh engines draft by prompt-lookup"
    from dnet_tpu_torch.parallel.engine import MeshEngine

    try:
        return MeshEngine(model_dir, pp=mesh.get("pp", 0), tp=mesh.get("tp", 1), dp=mesh.get("dp", 1),
                          sp=mesh.get("sp", 1), max_seq=args.max_seq, param_dtype=args.param_dtype,
                          device=args.device, spec_lookahead=args.spec)
    except EngineCapabilityError as exc:
        return str(exc)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logger(role="api")
    procs = mesh_settings().num_processes
    if procs > 1:
        return _refuse(f"DNET_MESH_NUM_PROCESSES={procs}: multi-process pods need the distributed runtime, "
                       "which is not ported (ROADMAP A7); run one process")

    from dnet_tpu_torch.api.model_manager import resolve_model_dir
    from dnet_tpu_torch.core.types import DecodingParams
    from dnet_tpu_torch.utils.tokenizer import load_tokenizer

    models_dir = api_settings().models_dir
    model_dir = resolve_model_dir(args.model, models_dir)
    if model_dir is None:
        return _refuse(f"model {args.model!r} not found")
    draft_dir = None
    if args.draft:
        draft_dir = resolve_model_dir(args.draft, models_dir)
        if draft_dir is None:
            return _refuse(f"draft model {args.draft!r} not found")
        if args.spec <= 0:
            return _refuse("--draft needs --spec L")
    engine = _engine(args, model_dir, draft_dir)
    if isinstance(engine, str):
        return _refuse(engine)
    tokenizer = load_tokenizer(model_dir)
    dec = DecodingParams(temperature=args.temperature, top_p=args.top_p, seed=args.seed)
    eos = set(tokenizer.eos_token_ids)

    src = sys.stdin if args.prompts == "-" else open(args.prompts)
    prompts = [ln.rstrip("\n") for ln in src if ln.strip()]
    if src is not sys.stdin:
        src.close()
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        for i, prompt in enumerate(prompts):
            if args.raw:
                ids = tokenizer.encode(prompt)
            else:
                ids = tokenizer.encode(tokenizer.apply_chat_template([{"role": "user", "content": prompt}]),
                                       add_bos=False)
            t0 = time.perf_counter()
            toks = [r.token_id for r in engine.generate(ids, dec, max_tokens=args.max_tokens, eos_token_ids=eos,
                                                        nonce=f"gen{i}")]
            dt = time.perf_counter() - t0
            if toks and toks[-1] in eos:
                toks = toks[:-1]
            out.write(json.dumps({"prompt": prompt, "text": tokenizer.decode(toks), "tokens": len(toks),
                                  "tok_s": round(len(toks) / max(dt, 1e-9), 2)}) + "\n")
            out.flush()
    finally:
        if out is not sys.stdout:
            out.close()
        engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
