"""The ring's failure handling on the port, held to the reference.

- The fault (the port's missing fast-fail): a real port ring on the CPU
  (two `dnet_tpu_torch.cli.shard` processes, `dnet_tpu_torch.cli.api
  --hostfile` without --auto-recover) whose shard s1 is killed mid-request.
  The in-flight request ends with the reference's error event and a new
  request gets the reference's 503 body (both captured from the
  reference's API stack over the same scenario in process), each within
  5 s of the kill, and /health reads "degraded".  s1 restarted without
  weights is seen healthy again; a re-installed topology's delta reload
  updates s0 in place and loads s1 in full, and the ring serves the
  single process's bytes again.  The same ring first answers POST
  /v1/prepare_topology with a split covering every layer once.
- The monitor's recovery and rejoin logic (tests/subsystems/
  test_membership.py's cases): convergence over two failures, a failing
  reload retried then restored, no capacity, a solver-dropped healthy
  shard quarantined, the rejoin arc, a rejoin the solver does not place,
  a failed rejoin re-shipping the restored topology, rejoin off, and the
  `rejoin` chaos point; each runs on both packages' RingFailureMonitor
  over the same stubs, and the traces must be equal."""

import asyncio
import importlib
import json
import signal
import subprocess
import sys
import time
import types

import httpx
import pytest

from dnet_tpu.config import reset_settings_cache
from tests.fakes.transport import FakeRingClient
from tests.test_torch_ring_serving import ROOT, _free_port, _normalize, _single_process, _wait_health

pytestmark = [pytest.mark.api, pytest.mark.ring]

PKGS = ("dnet_tpu", "dnet_tpu_torch")


def _pkg(name: str) -> types.SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        failure=mod("api.failure"), inference=mod("api.inference"), http=mod("api.http"),
        strategies=mod("api.strategies"), types=mod("core.types"), obs=mod("obs"), chaos=mod("resilience.chaos"),
        tokenizer=mod("utils.tokenizer"), ring_manager=mod("api.ring_manager"), name=name,
    )


class FlakyClient(FakeRingClient):
    """Health checks fail while the client's address is in `dead`."""

    dead: set = set()

    async def health_check(self, timeout=5.0):
        if self.addr in self.dead:
            raise ConnectionError(f"{self.addr} unreachable")
        return await super().health_check(timeout)


# ---- the fault's bodies, from the reference's API stack in process ---------


def _in_process_fault(name: str) -> tuple:
    """(the in-flight stream's last SSE event, the new request's status and
    body, /health status) of package `name`'s API node when the monitor
    marks s1 down mid-stream: the scenario of
    tests/subsystems/test_failure_monitor.py::test_detects_down_and_fast_fails_inflight
    driven through the HTTP server."""
    from aiohttp.test_utils import TestClient, TestServer

    p = _pkg(name)

    class StubAdapter(p.strategies.ApiAdapterBase):
        """Step 0 answers at once; later steps wait for the ring."""

        def __init__(self):
            self._futures = p.strategies._TokenFutures()

        async def start(self): ...

        async def shutdown(self): ...

        async def reset_cache(self, nonce): ...

        async def send_tokens(self, nonce, ids, dec, step, budget=None):
            fut = self._futures.expect(nonce, step)
            if step == 0:
                fut.get_loop().call_soon(
                    lambda: self._futures.resolve(p.types.TokenResult(nonce=nonce, token_id=72, step=0)))

        async def await_token(self, nonce, step, timeout):
            return await self._futures.wait(nonce, step, timeout)

    T = p.types
    topo = T.TopologyInfo(
        model="m", num_layers=4, kv_bits=0,
        devices=[T.DeviceInfo(instance="s0", host="h0", http_port=1, grpc_port=10),
                 T.DeviceInfo(instance="s1", host="h1", http_port=2, grpc_port=20)],
        assignments=[T.LayerAssignment(instance="s0", layers=[0, 1], next_instance="s1"),
                     T.LayerAssignment(instance="s1", layers=[2, 3], next_instance="s0")])
    cluster = types.SimpleNamespace(current_topology=topo, epoch=1)

    async def go():
        FlakyClient.dead = set()
        inference = p.inference.InferenceManager(StubAdapter(), request_timeout_s=30.0)
        inference.tokenizer = p.tokenizer.ByteTokenizer()
        inference.model_id = "m"
        monitor = p.failure.RingFailureMonitor(cluster, inference, interval_s=0.01, fail_threshold=2,
                                               ring_client_factory=FlakyClient)
        inference.failure_monitor = monitor
        manager = types.SimpleNamespace(current_model_id="m", models_dir=None, engine=None)
        client = TestClient(TestServer(p.http.ApiHTTPServer(inference, manager).app))
        await client.start_server()
        try:
            await monitor._tick()
            body = {"model": "m", "messages": [{"role": "user", "content": "x"}], "max_tokens": 8, "stream": True}
            resp = await client.post("/v1/chat/completions", json=body)
            first = await resp.content.readline()
            assert first.startswith(b"data: {")
            FlakyClient.dead = {"h1:20"}
            await monitor._tick()
            await monitor._tick()  # the second failure: s1 down, in-flight futures failed
            events = [ln for ln in (first + await resp.content.read()).decode().split("\n") if ln]
            r = await client.post("/v1/chat/completions", json=dict(body, stream=False))
            status = (await (await client.get("/health")).json())["status"]
            return events[-1], r.status, await r.text(), status
        finally:
            await client.close()
            FlakyClient.dead = set()

    return asyncio.run(go())


def test_in_process_fault_answers_as_the_reference():
    assert _in_process_fault("dnet_tpu_torch") == _in_process_fault("dnet_tpu")


# ---- a real port ring --------------------------------------------------------

MAX_SEQ = 64
CHAT = {"model": "tiny", "messages": [{"role": "user", "content": "Tell me a story"}], "max_tokens": 40,
        "temperature": 0, "stream": True}


class FaultRing:
    """Two port shards (s1 computes each frame 50 ms late, a chaos delay, so
    that a kill lands mid-request) and an API node that detects a dead
    shard within 2 probes 0.1 s apart and does not recover."""

    def __init__(self, tmp_path):
        self.tmp = tmp_path
        self.env = {k: v for k, v in __import__("os").environ.items() if not k.startswith(("JAX_", "XLA_", "DNET_"))}
        self.env["PYTHONPATH"] = str(ROOT)
        self.shards = [(f"s{i}", _free_port(), _free_port()) for i in range(2)]
        self.procs = {}
        hostfile = tmp_path / "hostfile"
        hostfile.write_text("".join(f"{n} 127.0.0.1 {h} {g}\n" for n, h, g in self.shards))
        for i in range(2):
            self.start_shard(i)
        self.http = _free_port()
        self._spawn("api", dict(self.env, DNET_API_HEALTH_INTERVAL_S="0.1", DNET_API_HEALTH_FAIL_THRESHOLD="2"),
                    "dnet_tpu_torch.cli.api", "--device", "cpu", "--host", "127.0.0.1", "--http-port",
                    str(self.http), "--grpc-port", str(_free_port()), "--hostfile", str(hostfile),
                    "--max-seq-len", str(MAX_SEQ), "--param-dtype", "bfloat16", "--request-timeout-s", "20")
        self.base = f"http://127.0.0.1:{self.http}"
        for i, (_, http, _) in enumerate(self.shards):
            _wait_health(f"http://127.0.0.1:{http}", self.procs[f"s{i}"])
        _wait_health(self.base, self.procs["api"])

    def _spawn(self, key, env, module, *args):
        log = open(self.tmp / f"{key}.log", "a")
        self.procs[key] = subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT, env=env, stdout=log,
                                           stderr=subprocess.STDOUT, text=True)

    def start_shard(self, i):
        name, http, grpc_port = self.shards[i]
        env = dict(self.env, DNET_CHAOS="shard_compute:delay:50ms") if i == 1 else self.env
        self._spawn(name, env, "dnet_tpu_torch.cli.shard", "--device", "cpu", "--host", "127.0.0.1",
                    "--http-port", str(http), "--grpc-port", str(grpc_port), "--shard-name", name,
                    "--discovery", "none")

    def post(self, path, body, timeout=60):
        return httpx.post(self.base + path, json=body, timeout=timeout)

    def stop(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in self.procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def fring(tmp_path_factory):
    r = FaultRing(tmp_path_factory.mktemp("fring"))
    try:
        yield r
    finally:
        r.stop()


def _manual(fring, model_dir):
    r = fring.post("/v1/prepare_topology_manual", {
        "model": str(model_dir),
        "assignments": [{"instance": "s0", "layers": [0, 1]}, {"instance": "s1", "layers": [2, 3]}]})
    assert r.status_code == 200, r.text
    return r.json()["topology"]["epoch"]


def test_prepare_topology_solves_over_the_cpu_shards(fring, tiny_llama_dir):
    """Both shards profiled (the reference's keys), the layers covered once
    in contiguous ranges, one round, single-device shards."""
    r = fring.post("/v1/prepare_topology", {"model": str(tiny_llama_dir)})
    assert r.status_code == 200, r.text
    topo = r.json()["topology"]
    layers = [a["layers"] for a in topo["assignments"]]
    assert sorted(x for ls in layers for x in ls) == [0, 1, 2, 3]
    assert all(ls == list(range(ls[0], ls[-1] + 1)) for ls in layers)
    assert topo["solution"]["k"] == 1 and topo["solution"]["solver"] in ("greedy", "milp")
    assert all((a["mesh_tp"], a["mesh_sp"], a["window_size"]) == (1, 1, 0) for a in topo["assignments"])
    got = httpx.get(fring.base + "/v1/topology", timeout=10).json()["topology"]
    assert (got["epoch"], got["assignments"], got["kv_bits"]) == (topo["epoch"], topo["assignments"], 0)
    devices = httpx.get(fring.base + "/v1/devices", timeout=10).json()["devices"]
    assert [d["instance"] for d in devices] == ["s0", "s1"]
    shard = f"http://127.0.0.1:{fring.shards[0][1]}"
    profile = httpx.post(shard + "/profile", json={}, timeout=60).json()["profile"]
    assert profile["platform"] == "cpu" and profile["flops_bf16"] > 0 and profile["local_device_count"] == 1
    lat = httpx.post(shard + "/measure_latency", timeout=60, json={
        "peers": [f"127.0.0.1:{fring.shards[1][2]}"], "payload_sizes": [1024], "rounds": 2}).json()
    assert lat["latency"][f"127.0.0.1:{fring.shards[1][2]}"]["1024"] > 0


def test_dead_shard_fails_fast_with_the_reference_answers(fring, tiny_llama_dir):
    """Kill s1 after the 3rd streamed chunk: the stream ends with the
    reference's error event and a new request gets its 503, both within
    5 s (the request timeout is 20 s), and /health reads degraded."""
    _manual(fring, tiny_llama_dir)
    assert fring.post("/v1/load_model", {"model": str(tiny_llama_dir)}, timeout=120).status_code == 200
    want_event, want_status, want_body, want_health = _in_process_fault("dnet_tpu")
    t_kill = None
    lines = []
    with httpx.stream("POST", fring.base + "/v1/chat/completions", json=CHAT, timeout=60) as r:
        assert r.status_code == 200
        for line in r.iter_lines():
            if line:
                lines.append(line)
            if t_kill is None and len([ln for ln in lines if '"content"' in ln]) == 3:
                fring.procs["s1"].send_signal(signal.SIGKILL)
                t_kill = time.monotonic()
    t_error = time.monotonic()
    r = fring.post("/v1/chat/completions", dict(CHAT, stream=False))
    t_503 = time.monotonic()
    assert lines[-1] == want_event
    assert json.loads(want_event[len("data: "):]) == {
        "error": {"message": "shard s1 is unreachable", "type": "server_error"}}
    assert (r.status_code, r.text) == (want_status, want_body) and want_status == 503
    assert t_error - t_kill < 5.0 and t_503 - t_kill < 5.0
    health = httpx.get(fring.base + "/health", timeout=10).json()
    assert health["status"] == want_health == "degraded"
    assert health["shards"]["s1"]["down"] and not health["shards"]["s0"]["down"]
    assert health["quarantine"] == {}  # no auto-recovery on this ring


def test_restarted_shard_takes_a_full_load_in_a_delta_reload(fring, tiny_llama_dir):
    """s1 comes back without weights: the monitor sees it healthy, and a
    re-installed topology's delta reload updates s0 in place (it keeps its
    weights) while s1 refuses the update and is loaded in full; the ring
    then serves the single process's bytes."""
    fring.start_shard(1)
    deadline = time.monotonic() + 60
    while httpx.get(fring.base + "/health", timeout=10).json()["status"] != "ok":
        assert time.monotonic() < deadline, "s1 never seen healthy again"
        time.sleep(0.1)
    epoch = _manual(fring, tiny_llama_dir)
    r = fring.post("/v1/load_model", {"model": str(tiny_llama_dir), "delta": True}, timeout=120)
    assert r.status_code == 200, r.text
    shard_epochs = [httpx.get(f"http://127.0.0.1:{h}/health", timeout=10).json()["epoch"] for _, h, _ in fring.shards]
    assert shard_epochs == [epoch, epoch]
    assert "delta update of s1 refused; falling back to a full load" in (fring.tmp / "api.log").read_text()
    assert f"shard s0 delta-updated to epoch {epoch}" in (fring.tmp / "s0.log").read_text()
    assert f"(epoch {epoch})" in (fring.tmp / "s1.log").read_text().split("loaded layers")[-1]
    body = dict(CHAT, max_tokens=12)
    with httpx.stream("POST", fring.base + "/v1/chat/completions", json=body, timeout=60) as r:
        got = r.read().decode()
    assert _normalize(got) == _normalize(_single_process(tiny_llama_dir, [body])[0][1])


# ---- the monitor's recovery and rejoin, on both packages ---------------------


def _devs(p, n):
    return [p.types.DeviceInfo(instance=f"s{i}", host=f"h{i}", http_port=i + 1, grpc_port=10 * (i + 1),
                               flops_bf16=1e14, hbm_bw=8e11, host_to_hbm_bw=1e10, hbm_bytes=16 << 30)
            for i in range(n)]


def _stub_topo(p, n):
    per = 4 // n
    las = [p.types.LayerAssignment(instance=f"s{i}", layers=list(range(i * per, (i + 1) * per)),
                                   next_instance=f"s{(i + 1) % n}") for i in range(n)]
    return p.types.TopologyInfo(model="m", num_layers=4, kv_bits=0, devices=_devs(p, n), assignments=las)


class StubCluster:
    def __init__(self, p, n, profiled):
        self.current_topology = _stub_topo(p, n)
        self.installed, self.restored = [], []
        self._profiled = profiled

    def install_topology(self, topo):
        topo.epoch = len(self.installed) + 1
        self.installed.append(topo)
        self.current_topology = topo
        return topo

    def restore_topology(self, topo):
        self.restored.append(topo)
        self.current_topology = topo

    async def profile_cluster(self):
        return self._profiled()


def _single_s0(p):
    def solve(devices, profile, **kw):
        return p.ring_manager.build_manual_topology("m", 4, [{"instance": "s0", "layers": [0, 1, 2, 3]}], devices)

    return solve


# scenario -> (shards, profiled count (None: nobody answers), load failures,
#   reload delay (s), monitor options, steps); a step is
#   ("dead", addrs) | ("tick",) | ("chaos", spec) | ("solver", "s0_only") | ("fail_next", n)
SCENARIOS = {
    "two_failures_converge": (3, 3, 0, 0.05, {}, [("dead", {"h1:20", "h2:30"}), ("tick",)]),
    "reload_fails_then_restores": (2, 2, 99, 0.0, {}, [("dead", {"h1:20"}), ("tick",)]),
    "no_capacity": (2, None, 0, 0.0, {}, [("dead", {"h0:10", "h1:20"}), ("tick",)]),
    "solver_drops_a_healthy_shard": (3, 3, 0, 0.0, {}, [("solver", "s0_only"), ("dead", {"h2:30"}), ("tick",)]),
    "rejoin_arc": (2, 2, 0, 0.0, {"rejoin": True}, [("dead", {"h1:20"}), ("tick",), ("dead", set()), ("tick",),
                                                    ("tick",)]),
    "rejoin_not_placed": (2, 2, 0, 0.0, {"rejoin": True}, [("dead", {"h1:20"}), ("tick",), ("solver", "s0_only"),
                                                           ("dead", set()), ("tick",)]),
    "failed_rejoin_reships": (2, 2, 0, 0.0, {"rejoin": True}, [("dead", {"h1:20"}), ("tick",), ("dead", set()),
                                                               ("fail_next", 3), ("tick",), ("tick",)]),
    "rejoin_off_keeps_probing": (2, 2, 0, 0.0, {"rejoin": False}, [("dead", {"h1:20"}), ("tick",), ("dead", set()),
                                                                   ("tick",), ("tick",)]),
    "rejoin_chaos_defers": (2, 2, 0, 0.0, {"rejoin": True}, [("dead", {"h1:20"}), ("tick",), ("dead", set()),
                                                             ("chaos", "rejoin:error:1.0"), ("tick",),
                                                             ("chaos", ""), ("tick",)]),
}


def _run_scenario(name, model_dir, scenario, monkeypatch):
    n, profiled_n, fail_loads, delay, opts, steps = scenario
    p = _pkg(name)
    cluster = StubCluster(p, n, lambda: [] if profiled_n is None else _devs(p, profiled_n))
    calls = []
    failures = {"left": fail_loads}

    class Manager:
        models_dir = None

        async def load_model(self, model_id, max_seq=None, delta=False):
            topo = cluster.current_topology
            calls.append((sorted(a.instance for a in topo.assignments), topo.epoch, delta))
            await asyncio.sleep(delay)
            if failures["left"] > 0:
                failures["left"] -= 1
                raise RuntimeError("shard load failed (500)")
            return 0.1

    inference = p.inference.InferenceManager(None, request_timeout_s=5.0)
    inference.tokenizer = p.tokenizer.ByteTokenizer()
    inference.model_id = str(model_dir)
    monitor = p.failure.RingFailureMonitor(
        cluster, inference, model_manager=Manager(), interval_s=0.01, fail_threshold=1, auto_recover=True,
        ring_client_factory=FlakyClient, rejoin_stable_s=0.0, **opts)
    fams = {"recovery": p.obs.metric("dnet_recovery_total"), "rejoins": p.obs.metric("dnet_shard_rejoins_total"),
            "retries": p.obs.metric("dnet_rpc_retries_total").labels(method="load_model"),
            "chaos": p.obs.metric("dnet_chaos_injected_total").labels(point="rejoin")}

    def counters():
        rec = fams["recovery"]
        return ([rec.labels(outcome=o).value for o in ("recovered", "failed", "no_capacity")],
                fams["rejoins"].value, fams["retries"].value, fams["chaos"].value)

    base = counters()
    trace = []

    async def go():
        for step in steps:
            if step[0] == "dead":
                FlakyClient.dead = set(step[1])
            elif step[0] == "solver":
                monkeypatch.setattr(f"{name}.parallel.solver.solve_topology", _single_s0(p))
            elif step[0] == "fail_next":
                failures["left"] = step[1]
            elif step[0] == "chaos":
                p.chaos.install_chaos(step[1], seed=5) if step[1] else p.chaos.clear_chaos()
            else:
                await monitor._tick()
                now = counters()
                q = monitor.quarantine
                trace.append((
                    sorted(q.instances()), monitor.down_shards(), cluster.current_topology.epoch,
                    sorted(a.instance for a in cluster.current_topology.assignments), list(calls),
                    [x - y for x, y in zip(now[0], base[0])], now[1] - base[1], now[2] - base[2], now[3] - base[3],
                    len(cluster.restored), [q.get(i).probes_ok > 0 for i in sorted(q.instances())],
                ))
        await monitor.stop()

    try:
        asyncio.run(go())
    finally:
        FlakyClient.dead = set()
        p.chaos.clear_chaos()
    return trace


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_monitor_recovery_and_rejoin_as_the_reference(scenario, tiny_llama_dir, monkeypatch):
    monkeypatch.setenv("DNET_RESILIENCE_RETRY_BASE_S", "0.001")
    monkeypatch.setenv("DNET_RESILIENCE_RETRY_MAX_S", "0.005")
    reset_settings_cache()
    try:
        ref = _run_scenario("dnet_tpu", tiny_llama_dir, SCENARIOS[scenario], monkeypatch)
        port = _run_scenario("dnet_tpu_torch", tiny_llama_dir, SCENARIOS[scenario], monkeypatch)
    finally:
        reset_settings_cache()
    assert port == ref
    last = port[-1]
    if scenario == "rejoin_arc":
        assert last[0] == [] and last[3] == ["s0", "s1"] and last[6] == 1
    if scenario == "two_failures_converge":
        assert last[0] == ["s1", "s2"] and last[3] == ["s0"] and last[5][0] == 2
