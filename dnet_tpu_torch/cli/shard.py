"""`dnet-torch-shard`: a ring shard of the port, serving a layer range.

    python -m dnet_tpu_torch.cli.shard --http-port 8081 --grpc-port 58081 [--device cpu]

The API node (`dnet-torch-api --hostfile <f>`) assigns its layers and next
hop through POST /load_model.  Runs on CUDA unless --device cpu is given,
and refuses to start when CUDA is absent.  The other flags default to their
DNET_SHARD_* settings, as the reference's.
"""

from __future__ import annotations

import argparse
import sys

from dnet_tpu_torch.config import shard_settings
from dnet_tpu_torch.utils.logger import setup_logger


def build_parser() -> argparse.ArgumentParser:
    """The flags, each defaulting to its DNET_SHARD_* setting (config.py
    `ShardSettings`, read when the parser is built); a flag given on the
    command line wins."""
    s = shard_settings()
    p = argparse.ArgumentParser(prog="dnet-torch-shard", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--host", default=s.host)
    p.add_argument("--http-port", type=int, default=s.http_port)
    p.add_argument("--grpc-port", type=int, default=s.grpc_port)
    p.add_argument("--queue-size", type=int, default=s.queue_size, help="ingress frames queued for compute")
    p.add_argument("--shard-name", default=s.name, help="instance name (default shard-<host>-<grpc port>)")
    p.add_argument("--models-dir", default=s.models_dir, help="where model ids resolve")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run there)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    log = setup_logger(role="shard")
    from dnet_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no CUDA and no --device cpu: refuse to start
    log.info("dnet-torch-shard %s starting on %s:%d (grpc %d, %s)", args.shard_name or "<unnamed>",
             args.host, args.http_port, args.grpc_port, args.device)
    from dnet_tpu_torch.shard.server import serve

    serve(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
