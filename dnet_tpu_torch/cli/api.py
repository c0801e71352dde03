"""`dnet-torch-api`: the port's API node, serving one model on one GPU.

    python -m dnet_tpu_torch.cli.api --model <dir> [--device cpu]
    python -m dnet_tpu_torch.cli.api --model <dir> --batch-slots 8
    DNET_KV_PAGED=1 DNET_KV_RAGGED=1 python -m dnet_tpu_torch.cli.api --model <dir> --batch-slots 8
    DNET_KV_BITS=8 python -m dnet_tpu_torch.cli.api --model <dir>    # int8 KV cache (4: int4)
    python -m dnet_tpu_torch.cli.api --hostfile <f>    # a ring of dnet-torch-shard nodes
    python -m dnet_tpu_torch.cli.api --model <dir> --mesh sp=2    # KV sharded over 2 cards

Runs on CUDA unless --device cpu is given, and refuses to start when CUDA
is absent.  Every flag but --model, --device and --hostfile defaults to its
DNET_API_* setting (DNET_API_HTTP_PORT, DNET_API_MAX_SEQ_LEN,
DNET_API_PARAM_DTYPE, ...), as the reference's.  --batch-slots N > 1
serves N concurrent requests by continuous batching, over dense per-slot KV
rows by default or over a paged KV pool with DNET_KV_PAGED=1 and
DNET_KV_RAGGED=1.  DNET_KV_BITS (0, 16, 8, 4) sets
the KV cache's form for the single-sequence and dense batched engines; a
paged pool takes the param dtype's cache only.
--hostfile serves through the shards it lists (`<instance> <host> <http_port>
<grpc_port>` per line): POST /v1/prepare_topology_manual assigns their layer
ranges, then POST /v1/load_model loads them; the tail shard calls the
sampled tokens back on --grpc-port.
--mesh sp=N (default: DNET_MESH_PP/TP/DP/SP) serves over N sequence-parallel
ranks, each holding max_seq / N KV slots: on CUDA one card per rank
(cuda:0 .. cuda:N-1; the server refuses to start with fewer cards), with
--device cpu every rank on the CPU; llama, gpt_oss and deepseek_v2, and
DNET_KV_BITS 8 / 4, serve under it.  The pp / tp / dp axes and
--batch-slots > 1 are refused (422) under a mesh.
"""

from __future__ import annotations

import argparse
import sys

from dnet_tpu_torch.config import api_settings
from dnet_tpu_torch.utils.logger import setup_logger


def build_parser() -> argparse.ArgumentParser:
    """The flags, each defaulting to its DNET_API_* setting (config.py
    `ApiSettings`, read when the parser is built), as the reference's CLI
    and server take them; a flag given on the command line wins."""
    s = api_settings()
    p = argparse.ArgumentParser(prog="dnet-torch-api", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--host", default=s.host)
    p.add_argument("--http-port", type=int, default=s.http_port)
    p.add_argument("--model", default="", help="model to load at startup (path or id)")
    p.add_argument("--models-dir", default=s.models_dir, help="where model ids resolve")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run there)")
    p.add_argument("--max-seq-len", type=int, default=s.max_seq_len, help="KV cache slots per request")
    p.add_argument("--param-dtype", default=s.param_dtype, choices=["bfloat16", "float32"])
    p.add_argument("--max-concurrent", type=int, default=s.max_concurrent_requests,
                   help="requests admitted at once (capped at --batch-slots when batching)")
    p.add_argument("--batch-slots", type=int, default=None,
                   help="continuous-batching slots (default DNET_API_BATCH_SLOTS, else 1)")
    p.add_argument("--request-timeout-s", type=float, default=s.request_timeout_s)
    p.add_argument("--hostfile", default="", help="serve through the ring of shards this file lists")
    p.add_argument("--grpc-port", type=int, default=s.grpc_port, help="ring mode: token callbacks from the tail")
    p.add_argument("--mesh", default="",
                   help="sequence-parallel serving, e.g. 'sp=2' (default: DNET_MESH_PP/TP/DP/SP)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    log = setup_logger(role="api")
    from dnet_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no CUDA and no --device cpu: refuse to start
    from dnet_tpu_torch.api.model_manager import active_mesh
    from dnet_tpu_torch.api.server import resolve_mesh
    from dnet_tpu_torch.parallel.mesh import rank_devices

    try:
        mesh = active_mesh(resolve_mesh(args))
        if mesh is not None:
            if args.hostfile:
                raise ValueError("--mesh with --hostfile: shard-local meshes are not ported")
            # one card per sp rank: refuse to start on a machine with fewer
            rank_devices(mesh.get("sp", 1), args.device)
    except ValueError as exc:
        log.error("%s", exc)
        return 2
    log.info("dnet-torch-api starting on %s:%d (%s)", args.host, args.http_port, args.device)
    from dnet_tpu_torch.api.server import serve

    serve(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
