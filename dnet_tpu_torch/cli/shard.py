"""`dnet-torch-shard`: a ring shard of the port, serving a layer range.

    python -m dnet_tpu_torch.cli.shard --http-port 8081 --grpc-port 58081 [--device cpu]
    python -m dnet_tpu_torch.cli.shard ... --cluster T --udp-target 127.255.255.255

The API node (`dnet-torch-api --hostfile <f>`, or `--discovery udp` with
the same --cluster) assigns its layers and next hop through POST
/load_model.  By default (--discovery udp, as the reference's) the shard
announces its name and ports over UDP broadcast to --udp-target on
--udp-port, scoped by the --cluster token; when discovery cannot start
(its library does not build or load, or the port cannot be bound) it logs
a warning and serves hostfile rings only.  Runs on CUDA unless
--device cpu is given, and refuses to start when CUDA is absent.  The
other flags default to their DNET_SHARD_* settings, as the reference's.
"""

from __future__ import annotations

import argparse
import sys

from dnet_tpu_torch.config import shard_settings
from dnet_tpu_torch.utils.logger import setup_logger
from dnet_tpu_torch.utils.p2p import DEFAULT_TARGET, DEFAULT_UDP_PORT


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
    p.add_argument("--discovery", choices=["udp", "none"], default="udp",
                   help="announce this shard over UDP broadcast (native lib)")
    p.add_argument("--udp-port", type=int, default=DEFAULT_UDP_PORT)
    p.add_argument("--udp-target", default=DEFAULT_TARGET,
                   help="announce target (loopback broadcast for single-host)")
    p.add_argument("--cluster", default="default", help="cluster token scoping UDP discovery membership")
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
