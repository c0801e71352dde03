"""Network address helpers (counterpart of dnet_tpu/utils/network.py)."""

from __future__ import annotations

import socket
from typing import Iterable

LOOPBACK = ("127.0.0.1", "localhost", "::1")


def primary_ip(peer_hosts: Iterable[str] = ()) -> str:
    """The address the given peers can reach this host on: loopback when
    every peer is loopback (or there are none), else the address of the
    interface that routes to the first other peer (a UDP connect, which
    sends no packet)."""
    others = [h for h in peer_hosts if h and h not in LOOPBACK]
    if not others:
        return "127.0.0.1"
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((others[0], 80))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
