"""`dnet-torch-api`: the port's API node, serving one model on one GPU.

    python -m dnet_tpu_torch.cli.api --model <dir> [--device cpu]
    DNET_KV_PAGED=1 DNET_KV_RAGGED=1 python -m dnet_tpu_torch.cli.api --model <dir> --batch-slots 8
    python -m dnet_tpu_torch.cli.api --hostfile <f>    # a ring of dnet-torch-shard nodes

Runs on CUDA unless --device cpu is given, and refuses to start when CUDA
is absent.  --batch-slots N > 1 serves N concurrent requests by continuous
batching over a paged KV pool (needs DNET_KV_PAGED=1 and DNET_KV_RAGGED=1).
--hostfile serves through the shards it lists (`<instance> <host> <http_port>
<grpc_port>` per line): POST /v1/prepare_topology_manual assigns their layer
ranges, then POST /v1/load_model loads them; the tail shard calls the
sampled tokens back on --grpc-port.
"""

from __future__ import annotations

import argparse
import sys

from dnet_tpu_torch.utils.logger import setup_logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dnet-torch-api", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--model", default="", help="model to load at startup (path or id)")
    p.add_argument("--models-dir", default="~/.dnet-tpu/models", help="where model ids resolve")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run there)")
    p.add_argument("--max-seq-len", type=int, default=4096, help="KV cache slots per request")
    p.add_argument("--param-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--max-concurrent", type=int, default=8,
                   help="requests admitted at once (capped at --batch-slots when batching)")
    p.add_argument("--batch-slots", type=int, default=None,
                   help="continuous-batching slots (default DNET_API_BATCH_SLOTS, else 1)")
    p.add_argument("--request-timeout-s", type=float, default=300.0)
    p.add_argument("--hostfile", default="", help="serve through the ring of shards this file lists")
    p.add_argument("--grpc-port", type=int, default=58080, help="ring mode: token callbacks from the tail")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    log = setup_logger(role="api")
    from dnet_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no CUDA and no --device cpu: refuse to start
    log.info("dnet-torch-api starting on %s:%d (%s)", args.host, args.http_port, args.device)
    from dnet_tpu_torch.api.server import serve

    serve(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
