"""UDP-broadcast LAN discovery: `UdpDiscovery`, a ctypes wrapper over
csrc/discovery.cpp.

Counterpart of dnet_tpu/utils/p2p.py.  The library builds with g++ at first
use into `build/dnet_tpu_torch/` (keyed by a hash of its source, as
utils/native_store.py builds the host store), under a name of its own and
with C symbols of its own (`dnet_torch_disc_*`), so a process can load it
beside the reference's `libdnetdisc.so`; a build failure raises, there is
no pure-Python path.  The port's copy joins its threads when a process
exits without `stop()` (the reference's aborts: see the source's header).

`UdpDiscovery` announces this node and keeps the live peer table, with the
surface of utils/hostfile.py `StaticDiscovery` (`peers()`), so the API's
ClusterManager reads either: `peers()` lists the peers of this node's
cluster token (another cluster sharing the LAN and port is left out), never
this node itself, and drops a peer silent for `ttl_s`; `get(instance)`;
`stop()`, also on leaving a `with` block.  One instance per process: the
library holds process-wide state, as the reference's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

from dnet_tpu_torch.core.types import DeviceInfo
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

SRC = Path(__file__).resolve().parents[1] / "csrc" / "discovery.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dnet_tpu_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
DEFAULT_UDP_PORT = 58899
DEFAULT_TARGET = "255.255.255.255"

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"discovery-{h.hexdigest()[:16]}.so"


def ensure_built() -> Path:
    """Compile the library unless this source is built already; raises
    RuntimeError with g++'s output when the build fails, or when g++ or
    the build directory cannot be reached."""
    out = library_path()
    if out.is_file():
        return out
    # a private name first: two processes may build at once
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:  # no g++ on PATH, an unwritable build directory
        raise RuntimeError(f"native discovery build failed ({' '.join(cmd)}): {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"native discovery build failed ({' '.join(cmd)}):\n{proc.stderr.strip()}")
    os.replace(tmp, out)
    return out


def lib():
    """The loaded library (built on first call); RuntimeError when it does
    not build or load."""
    global _lib
    with _lock:
        if _lib is None:
            path = ensure_built()
            try:
                handle = ctypes.CDLL(str(path))
            except OSError as exc:
                raise RuntimeError(f"native discovery library {path} did not load: {exc}") from exc
            handle.dnet_torch_disc_start.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ]
            handle.dnet_torch_disc_start.restype = ctypes.c_int
            handle.dnet_torch_disc_update.argtypes = [ctypes.c_char_p]
            handle.dnet_torch_disc_update.restype = None
            handle.dnet_torch_disc_peers.argtypes = [ctypes.c_char_p, ctypes.c_int]
            handle.dnet_torch_disc_peers.restype = ctypes.c_int
            handle.dnet_torch_disc_stop.argtypes = []
            handle.dnet_torch_disc_stop.restype = None
            _lib = handle
        return _lib


class UdpDiscovery:
    """Announce this node and keep a live LAN peer table."""

    def __init__(
        self,
        instance: str,
        http_port: int,
        grpc_port: int,
        is_manager: bool = False,
        slice_id: int = 0,
        udp_port: int = DEFAULT_UDP_PORT,
        target_addr: str = DEFAULT_TARGET,
        interval_ms: int = 500,
        ttl_s: float = 5.0,
        cluster: str = "default",
    ) -> None:
        """Starts announcing at once; raises RuntimeError when the library
        does not build or load, discovery already runs in this process or
        `udp_port` cannot be bound."""
        self.instance = instance
        self.cluster = cluster
        self._lib = lib()
        self._self = {
            "instance": instance,
            "cluster": cluster,  # scopes membership: two clusters may share a LAN and a port
            "http_port": str(http_port),
            "grpc_port": str(grpc_port),
            "is_manager": "1" if is_manager else "0",
            "slice_id": str(slice_id),
        }
        rc = self._lib.dnet_torch_disc_start(
            json.dumps(self._self, separators=(",", ":")).encode(), target_addr.encode(), udp_port,
            interval_ms, ctypes.c_double(ttl_s),
        )
        if rc == 1:
            raise RuntimeError("discovery already running in this process")
        if rc != 0:
            raise RuntimeError(f"discovery could not bind UDP port {udp_port} (already in use without "
                               "SO_REUSEPORT?)")

    def peers(self) -> List[DeviceInfo]:
        """The peers heard within the TTL, in this node's cluster."""
        # size, then fill: the table may grow in between, so retry with the
        # newly reported size until it fits
        needed = self._lib.dnet_torch_disc_peers(None, 0)
        for _ in range(5):
            buf = ctypes.create_string_buffer(needed)
            got = self._lib.dnet_torch_disc_peers(buf, needed)
            if got <= needed:
                break
            needed = got
        try:
            raw = json.loads(buf.value.decode() or "[]")
        except json.JSONDecodeError:
            log.warning("malformed peer table from native discovery")
            return []
        out = []
        for p in raw:
            if p.get("cluster", "default") != self.cluster:
                continue  # another deployment sharing the LAN and port
            try:
                out.append(DeviceInfo(
                    instance=p["instance"], host=p.get("addr", ""), http_port=int(p["http_port"]),
                    grpc_port=int(p["grpc_port"]), is_manager=p.get("is_manager") == "1",
                    slice_id=int(p.get("slice_id", 0)),
                ))
            except (KeyError, ValueError):
                continue
        return out

    def get(self, instance: str) -> Optional[DeviceInfo]:
        for d in self.peers():
            if d.instance == instance:
                return d
        return None

    def stop(self) -> None:
        self._lib.dnet_torch_disc_stop()

    def __enter__(self) -> "UdpDiscovery":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
