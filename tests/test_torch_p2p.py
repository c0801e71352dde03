"""UDP discovery in the port (dnet_tpu_torch/utils/p2p.py over
dnet_tpu_torch/csrc/discovery.cpp) against the reference's
(dnet_tpu/utils/p2p.py over native/discovery.cpp).

Single-process cases, as the reference's tier-1 ones
(tests/test_p2p_discovery.py): announce datagrams are injected straight
into one listener's UDP port, so nothing broadcasts and nothing sleeps for
seconds.  The same datagrams sent to both packages' listeners, each on its
own port in one process, give equal peer tables.  A process that starts
the port's discovery and exits without `stop()` exits 0 (the reference's
aborts).  End to end: two port shards announcing over loopback broadcast
(127.255.255.255) on a private port and cluster, and a port API with
--discovery udp that finds them, serve the greedy SSE a hostfile API gives
over the same shards.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import httpx
import pytest

pytestmark = [pytest.mark.integration, pytest.mark.ring]

ROOT = Path(__file__).resolve().parents[1]
PEER = {"instance": "peer-b", "cluster": "default", "http_port": "8181", "grpc_port": "58181",
        "is_manager": "0", "slice_id": "3"}


def free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _announce(port: int, payload) -> None:
    """One announce datagram into a listener (what a peer's announce loop
    broadcasts); bytes go as they are."""
    data = payload if isinstance(payload, bytes) else json.dumps(payload, separators=(",", ":")).encode()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.sendto(data, ("127.0.0.1", port))


def _wait(cond, deadline_s: float = 8.0, resend=None):
    """Poll `cond` (the native listener polls at 200 ms), calling `resend`
    each round so one dropped datagram cannot flake the test."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        if resend is not None:
            resend()
        time.sleep(0.05)
    return cond()


def _discovery(pkg: str):
    if pkg == "port":
        from dnet_tpu_torch.utils.p2p import UdpDiscovery
    else:
        from dnet_tpu.utils.p2p import UdpDiscovery
    return UdpDiscovery


def test_build_is_the_ports_own_library():
    """Built from the port's source into build/dnet_tpu_torch/, under a
    name and symbols of its own."""
    from dnet_tpu_torch.utils import p2p

    lib = p2p.ensure_built()
    assert lib.is_file() and lib.parent == ROOT / "build" / "dnet_tpu_torch"
    assert lib.name.startswith("discovery-") and lib.name != "libdnetdisc.so"
    assert p2p.SRC == ROOT / "dnet_tpu_torch" / "csrc" / "discovery.cpp"
    assert hasattr(p2p.lib(), "dnet_torch_disc_start")


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No pure-Python fallback: g++'s error surfaces."""
    from dnet_tpu_torch.utils import p2p

    bad = tmp_path / "discovery.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(p2p, "SRC", bad)
    monkeypatch.setattr(p2p, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native discovery build failed"):
        p2p.ensure_built()


def test_no_compiler_raises_the_build_error(tmp_path, monkeypatch):
    """g++ missing from PATH surfaces as the documented RuntimeError, not
    FileNotFoundError."""
    from dnet_tpu_torch.utils import p2p

    monkeypatch.setattr(p2p, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="native discovery build failed"):
        p2p.ensure_built()


_SHARD_WITHOUT_GXX = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from dnet_tpu_torch.utils import p2p
p2p.BUILD_DIR = Path({build!r})  # nothing built there: the shard must compile
from dnet_tpu_torch.cli.shard import main
sys.exit(main(sys.argv[1:]))
"""


def test_shard_without_a_compiler_serves_with_the_warning(tmp_path):
    """A shard under the default --discovery udp whose library cannot
    build (no g++ on PATH) warns, serves hostfile rings and exits 0 on
    SIGTERM, as the reference's shard does."""
    from tests.test_torch_ring_serving import _free_port, _wait_health

    http = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_", "DNET_"))}
    env["PATH"] = str(tmp_path)  # no g++ there
    script = _SHARD_WITHOUT_GXX.format(root=str(ROOT), build=str(tmp_path / "build"))
    proc = subprocess.Popen(
        [sys.executable, "-c", script, "--device", "cpu", "--host", "127.0.0.1", "--http-port", str(http),
         "--grpc-port", str(_free_port()), "--shard-name", "nogxx", "--udp-port", str(free_udp_port()),
         "--udp-target", "127.0.0.1", "--cluster", f"nogxx-{free_udp_port()}"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        health = _wait_health(f"http://127.0.0.1:{http}", proc)
        assert health["status"] == "ok", health
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert proc.returncode == 0, out
    assert "UDP discovery unavailable (native discovery build failed" in out, out
    assert "hostfile mode only" in out


def test_callback_address_is_resolved_at_load(monkeypatch):
    """Under --discovery udp the peer table is empty when the API starts,
    so the address the shards call back on is resolved at load, from the
    topology's shards: a shard on another host gets the interface facing
    it, never loopback."""
    import asyncio
    from argparse import Namespace

    from dnet_tpu_torch.api import ring_manager, server
    from dnet_tpu_torch.api.ring_manager import build_manual_topology
    from dnet_tpu_torch.core.types import DeviceInfo
    from dnet_tpu_torch.utils.network import LOOPBACK
    from tests.test_torch_ring_serving import _free_port

    faced = []

    def primary_ip(hosts):  # the interface facing a LAN host, without a route table
        hosts = list(hosts)
        faced.append(hosts)
        return "127.0.0.1" if all(h in LOOPBACK for h in hosts) else "192.0.2.7"

    monkeypatch.setattr(ring_manager, "primary_ip", primary_ip)
    grpc_port = _free_port()
    args = Namespace(hostfile="", discovery="udp", udp_port=free_udp_port(), udp_target="127.0.0.1",
                     cluster=f"cb-{free_udp_port()}", host="127.0.0.1", http_port=_free_port(),
                     grpc_port=grpc_port, models_dir=None, max_seq_len=64, param_dtype="float32",
                     request_timeout_s=5.0)

    async def load_bodies():
        manager, cluster, grpc_server = await server._ring_mode(args, None)
        try:
            assert cluster.discovery.peers() == []  # nothing heard yet
            devices = [DeviceInfo(f"s{i}", f"10.0.0.{5 + i}", 8081 + i, 58081 + i) for i in range(2)]
            topo = build_manual_topology("tiny", 4, [{"instance": "s0", "layers": [0, 1]},
                                                     {"instance": "s1", "layers": [2, 3]}], devices)
            return manager.load_bodies(topo, "tiny", 64)
        finally:
            cluster.discovery.stop()
            await grpc_server.stop(0)

    bodies = asyncio.run(load_bodies())
    assert faced == [["10.0.0.5", "10.0.0.6"]]
    assert {b["api_callback_address"] for b in bodies.values()} == {f"grpc://192.0.2.7:{grpc_port}"}


def test_injected_peer_appears_and_filters():
    """The reference's tier-1 case on the port's class: the sender's
    address stamped, fields parsed, another cluster filtered out, self
    excluded, a malformed datagram absorbed."""
    UdpDiscovery = _discovery("port")
    port = free_udp_port()
    with UdpDiscovery("peer-a", 8080, 58080, udp_port=port, target_addr="127.0.0.1", interval_ms=50) as disc:
        _announce(port, b"{not json")
        _announce(port, {**PEER, "instance": "other", "cluster": "lan-2"})
        found = _wait(lambda: disc.get("peer-b"), resend=lambda: _announce(port, PEER))
        assert found is not None, "injected peer never appeared"
        assert (found.http_port, found.grpc_port, found.slice_id, found.is_manager) == (8181, 58181, 3, False)
        assert found.host.startswith("127.")
        assert disc.get("other") is None
        assert disc.get("peer-a") is None


def test_ttl_evicts_a_silent_peer():
    UdpDiscovery = _discovery("port")
    port = free_udp_port()
    ghost = {**PEER, "instance": "ghost"}
    with UdpDiscovery("watcher", 3, 4, udp_port=port, target_addr="127.0.0.1", interval_ms=50,
                      ttl_s=0.5) as disc:
        assert _wait(lambda: disc.get("ghost"), resend=lambda: _announce(port, ghost)) is not None
        # no further announces: the sweep (driven by the watcher's own
        # announces reaching its listener) drops it
        assert _wait(lambda: disc.get("ghost") is None), "stale peer not evicted"


def test_both_packages_give_the_same_peer_table():
    """The same datagrams (two shards, a manager, another cluster, a
    malformed one, the listener's own name) into each package's listener,
    each on its own port: equal DeviceInfo tables."""
    datagrams = [PEER, {**PEER, "instance": "s1", "http_port": "9", "grpc_port": "10", "slice_id": "0"},
                 {**PEER, "instance": "api", "is_manager": "1"}, {**PEER, "instance": "x", "cluster": "other"},
                 b'{"instance":"bad","http_port":"nan"}', {**PEER, "instance": "me"}]
    tables = []
    for pkg in ("port", "ref"):
        port = free_udp_port()
        with _discovery(pkg)("me", 1, 2, udp_port=port, target_addr="127.0.0.1", interval_ms=50) as disc:

            def send():
                for d in datagrams:
                    _announce(port, d)

            send()
            peers = _wait(lambda: len(disc.peers()) == 3 and disc.peers(), resend=send)
            tables.append(sorted((d.instance, d.host, d.http_port, d.grpc_port, d.is_manager, d.slice_id)
                                 for d in peers))
    assert tables[0] == tables[1]
    assert [t[0] for t in tables[0]] == ["api", "peer-b", "s1"]


_EXIT_WITHOUT_STOP = """
import sys, time
sys.path.insert(0, {root!r})
from {pkg}.utils.p2p import UdpDiscovery
d = UdpDiscovery("leaver", 1, 2, udp_port={port}, target_addr="127.0.0.1", interval_ms=50)
time.sleep(0.2)
"""


@pytest.mark.parametrize("pkg,code", [("dnet_tpu_torch", 0), ("dnet_tpu", -6)], ids=["port", "reference"])
def test_exit_without_stop(pkg, code):
    """C11: the port's process exits 0 without calling stop(); the
    reference's copy aborts at exit (a joinable std::thread destroyed:
    SIGABRT), which the port's static guard repairs."""
    proc = subprocess.run(
        [sys.executable, "-c", _EXIT_WITHOUT_STOP.format(root=str(ROOT), pkg=pkg, port=free_udp_port())],
        cwd=ROOT, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == code, proc.stderr
    if code == 0:
        assert "terminate called" not in proc.stderr


def test_api_over_discovered_shards_serves_the_hostfile_rings_sse(tiny_llama_dir, tmp_path):
    """Two port shards announcing on a private port and cluster; a port API
    with --discovery udp lists both on /v1/devices (not itself: it is a
    manager), loads them and serves greedy SSE byte-identical (but `id` and
    `created`) to a hostfile API's over the same shards, which then reload;
    every process exits 0."""
    from tests.test_torch_ring_serving import CHAT, CpuRing, _normalize

    flags = ["--discovery", "udp", "--udp-port", str(free_udp_port()), "--udp-target", "127.255.255.255",
             "--cluster", f"t-{free_udp_port()}"]
    requests = [dict(CHAT, stream=True), dict(CHAT, stream=True, max_tokens=20,
                                              messages=[{"role": "user", "content": "Tell me a story"}])]
    ring = CpuRing(tmp_path, shard_args=flags, api_args=flags)
    bodies, outcomes = [], []
    try:
        for api in (flags, None):
            if api is None:
                ring.start_api()  # --hostfile over the same shards
            devices = _wait(lambda: _listed(ring.base) >= {"s0", "s1"}
                            and httpx.get(ring.base + "/v1/devices", timeout=5).json()["devices"], deadline_s=20)
            assert devices and {d["instance"] for d in devices} == {"s0", "s1"}, devices
            ports = {d["instance"]: (d["http_port"], d["grpc_port"]) for d in devices}
            assert [ports[n] for n, _, _ in ring.shards] == [(h, g) for _, h, g in ring.shards]
            ring.load(tiny_llama_dir)
            bodies.append([httpx.post(ring.base + "/v1/chat/completions", json=b, timeout=120).text
                           for b in requests])
            outcomes.append(ring.stop_api())
    finally:
        outcomes += ring.stop()
    for code, text in outcomes:
        assert code == 0, text
    assert [_normalize(b) for b in bodies[0]] == [_normalize(b) for b in bodies[1]]
    assert all(b.endswith("data: [DONE]\n\n") for b in bodies[0])


def _listed(base: str) -> set:
    return {d["instance"] for d in httpx.get(base + "/v1/devices", timeout=5).json()["devices"]}
