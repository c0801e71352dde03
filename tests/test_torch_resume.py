"""Transparent resume (DNET_RESILIENCE_RESUME) and auto-recovery on the port,
held to the reference.

- The reference's resume cases (tests/subsystems/test_request_resume.py)
  run on both packages' decode loops over the same scripted fake adapter
  and monitor, and must end the same way: text, finish reason, usage,
  replays, raised errors.
- The chaos case: a two-shard in-process ring whose shard compute faults
  mid-decode (`shard_compute:error_at:5`, seed 11) resumes to the same
  text, usage, finish reason and counter deltas on both packages.
- A real port ring on the CPU (two `dnet_tpu_torch.cli.shard` processes and
  `dnet_tpu_torch.cli.api --auto-recover`): s1 is killed mid-stream, the
  stream completes on its rid byte-identical to the unfaulted one, the
  monitor re-solves over s0 (epoch + 1, s1 quarantined) and the recovered
  ring serves the same bytes; a frame from the fenced epoch is refused and
  counted; s1 is started again and rejoins, or stays quarantined, as the
  solver places it (on two CPU shards of a tiny model the placement
  follows timing noise, so only what does not depend on it is held), and
  the ring serves the same bytes.  The rejoin's scenarios with a fixed
  placement run on both packages' monitors in tests/test_torch_failure.py."""

import asyncio
import importlib
import re
import signal
import subprocess
import time
import types

import httpx
import pytest

from dnet_tpu.config import reset_settings_cache
from tests.test_torch_ring_serving import _normalize, _single_process, _wait_health

pytestmark = [pytest.mark.api, pytest.mark.chaos]

PKGS = ["dnet_tpu", "dnet_tpu_torch"]
MAX_SEQ = 64
_RESUME_ENV = {"DNET_RESILIENCE_RESUME": "1", "DNET_RESILIENCE_RESUME_DEADLINE_S": "2.0",
               "DNET_RESILIENCE_MAX_RESUMES": "2"}


def _pkg(name: str) -> types.SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        inference=mod("api.inference"), schemas=mod("api.schemas"), strategies=mod("api.strategies"),
        types=mod("core.types"), obs=mod("obs"), chaos=mod("resilience.chaos"), tokenizer=mod("utils.tokenizer"),
        ring=mod("api.ring"), name=name,
    )


@pytest.fixture
def resume_env(monkeypatch):
    for k, v in _RESUME_ENV.items():
        monkeypatch.setenv(k, v)
    reset_settings_cache()
    yield monkeypatch
    reset_settings_cache()


def _fake_adapter(p, script, fail_at=(), fail_forever_at=(), monitor=None, send_raises_at=(), bug_at_step=None,
                  reset_bomb=False):
    """The reference's ResumableFakeAdapter over package `p`: the token of
    generation index i is script[i], i = len(context) - prompt length, so a
    replay of prompt + generated continues the same stream."""

    class Adapter(p.strategies.ApiAdapterBase):
        def __init__(self):
            self.fail_at, self.fail_forever_at = set(fail_at), set(fail_forever_at)
            self._failed, self.contexts, self.prompt_len = set(), {}, None
            self.resets, self.replays = [], []
            self._futures = p.strategies._TokenFutures()

        async def start(self): ...

        async def shutdown(self): ...

        async def reset_cache(self, nonce):
            self.resets.append(nonce)
            if reset_bomb and self.prompt_len is not None:
                raise ConnectionError("ring is gone")

        async def send_tokens(self, nonce, token_ids, decoding, step, budget=None):
            if bug_at_step is not None and step == bug_at_step:
                raise ValueError("logic bug, not a transport failure")
            idx = len(self.contexts.get(nonce, [])) + len(token_ids) - (self.prompt_len or len(token_ids))
            if step > 0 and idx in send_raises_at and idx not in self._failed:
                self._failed.add(idx)
                raise ConnectionResetError("stream torn past retry budget")
            fut = self._futures.expect(nonce, step)
            if step == 0:
                self.contexts[nonce] = list(token_ids)
                if self.prompt_len is None:
                    self.prompt_len = len(token_ids)
                else:
                    self.replays.append((nonce, list(token_ids)))
            else:
                self.contexts[nonce].extend(token_ids)
            idx = len(self.contexts[nonce]) - self.prompt_len
            if idx in self.fail_forever_at or (idx in self.fail_at and idx not in self._failed):
                self._failed.add(idx)
                if monitor is not None:
                    monitor.trip()
                result = p.types.TokenResult(nonce=nonce, token_id=-1, step=step,
                                             error=f"shard s1 is unreachable (idx {idx})")
            else:
                tok = script[idx] if idx < len(script) else 257  # EOS
                result = p.types.TokenResult(nonce=nonce, token_id=tok, step=step)
            fut.get_loop().call_soon(lambda: self._futures.resolve(result))

        async def await_token(self, nonce, step, timeout):
            return await self._futures.wait(nonce, step, timeout)

    return Adapter()


class CountdownMonitor:
    """Degraded for `true_reads` reads after trip(): recovery without the
    wall clock."""

    def __init__(self, true_reads=3):
        self.true_reads, self._n = true_reads, 0

    def trip(self):
        self._n = self.true_reads

    @property
    def degraded(self):
        if self._n > 0:
            self._n -= 1
            return True
        return False

    def down_shards(self):
        return ["s1"]


def _outcome(p, script, request, monitor_reads=None, **kw):
    """Run one request through package p's decode loop; the end state."""
    monitor = CountdownMonitor(monitor_reads) if monitor_reads is not None else None
    adapter = _fake_adapter(p, list(script), monitor=monitor, **kw)
    m = p.inference.InferenceManager(adapter, request_timeout_s=5.0)
    m.tokenizer = p.tokenizer.ByteTokenizer()
    m.model_id = "fake"
    m.failure_monitor = monitor
    req = p.schemas.ChatCompletionRequest.model_validate(
        dict({"model": "fake", "messages": [{"role": "user", "content": "hi"}]}, **request))
    resumed = p.obs.metric("dnet_request_resumed_total")
    replayed = p.obs.metric("dnet_resume_replay_tokens_total")
    r0, t0 = resumed.value, replayed.value
    try:
        out = asyncio.run(m.generate(req))
    except Exception as exc:  # noqa: BLE001 - the raised error is the outcome
        end = ("raised", type(exc).__name__, str(exc))
    else:
        ch = out.choices[0]
        lps = [e.token for e in ch.logprobs.content] if ch.logprobs else None
        end = ("ok", ch.message.content, ch.finish_reason, out.usage.model_dump(), lps)
    replays = [(n[len(n) - 3:], ids[adapter.prompt_len:]) for n, ids in adapter.replays]
    dead_reset = any("#r" not in r for r in adapter.resets[1:])
    return end, replays, dead_reset, resumed.value - r0, replayed.value - t0


CASES = {
    # the fault mid-decode: the same text, finish reason and usage as without it
    "mid_decode": (b"hello world", {"max_tokens": 20}, {"fail_at": {5}}),
    "no_fault": (b"hello world", {"max_tokens": 20}, {}),
    # the fault raised by the send path (a torn stream) resumes too
    "send_raises": (b"hello", {"max_tokens": 10}, {"send_raises_at": {3}}),
    # a non-transient error is never replayed
    "logic_bug": (b"hello", {"max_tokens": 10}, {"bug_at_step": 2}),
    # the stop-sequence holdback and the logprob buffers survive a resume
    "stop_holdback": (b"helloENDworld", {"max_tokens": 20, "stop": "END"}, {"fail_at": {7}}),
    "logprobs": (b"abc", {"max_tokens": 10, "logprobs": True}, {"fail_at": {1}}),
    # DNET_RESILIENCE_MAX_RESUMES replays, then the failure surfaces
    "exhausted": (b"hello", {"max_tokens": 10}, {"fail_forever_at": {2}}),
    # the replay waits for the monitor to report the ring healthy
    "waits_out_degraded": (b"hey", {"max_tokens": 10}, {"fail_at": {1}, "monitor_reads": 3}),
    # a cleanup reset that raises does not mask the result
    "cleanup_reset_raises": (b"ok", {"max_tokens": 10}, {"reset_bomb": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_cases_end_as_the_reference(resume_env, case):
    script, request, kw = CASES[case]
    ref = _outcome(_pkg("dnet_tpu"), script, request, **kw)
    port = _outcome(_pkg("dnet_tpu_torch"), script, request, **kw)
    assert port == ref
    if case in ("mid_decode", "send_raises", "stop_holdback", "logprobs", "waits_out_degraded"):
        assert port[0][0] == "ok" and len(port[1]) == 1 and port[1][0][0] == "#r1" and port[3] == 1
    if case == "mid_decode":
        assert port[0][1] == "hello world" and port[1][0][1] == list(b"hello") and port[2]


@pytest.mark.parametrize("resume", ["1", "0"])
def test_resume_off_or_never_recovering_fails_fast(monkeypatch, resume):
    """Resume off: the fast-fail path, unchanged.  Resume on but the ring
    never recovers: the replay waits out its deadline, then fails alike."""
    monkeypatch.setenv("DNET_RESILIENCE_RESUME", resume)
    monkeypatch.setenv("DNET_RESILIENCE_RESUME_DEADLINE_S", "0.3")
    reset_settings_cache()
    try:
        outs = []
        for name in PKGS:
            t0 = time.monotonic()
            outs.append(_outcome(_pkg(name), b"hey", {"max_tokens": 10}, fail_at={1},
                                 monitor_reads=10_000 if resume == "1" else None))
            waited = time.monotonic() - t0
            assert waited >= 0.3 if resume == "1" else waited < 2.0
        assert outs[0] == outs[1]
        assert outs[1][0][:2] == ("raised", "InferenceError") and outs[1][1] == []
    finally:
        reset_settings_cache()


@pytest.mark.parametrize("batch_slots", [1, 4])
def test_local_and_batched_adapters_resume_through_the_same_wrapper(tiny_llama_dir, resume_env, batch_slots):
    """Both packages' single-sequence and batched adapters (the port's on
    its plain versions on the CPU) behind the same ResumableDecode: a step
    that fails once mid-decode is replayed as prompt + generated, and the
    text, usage and finish reason equal the unfaulted request's, and the
    reference's, with one resume counted on each."""

    async def go(p):
        model_manager = importlib.import_module(f"{p.name}.api.model_manager")
        inference = p.inference.InferenceManager(adapter=None, request_timeout_s=60.0)
        device = {"device": "cpu"} if p.name == "dnet_tpu_torch" else {}
        manager = model_manager.LocalModelManager(inference, max_seq=MAX_SEQ, param_dtype="float32",
                                                  batch_slots=batch_slots, **device)
        await manager.load_model(str(tiny_llama_dir))
        adapter = inference.adapter
        real_await, failed = adapter.await_token, []

        async def await_token(nonce, step, timeout):
            result = await real_await(nonce, step, timeout)
            if step == 5 and not failed:  # the step's token is lost once
                failed.append(nonce)
                return p.types.TokenResult(nonce=nonce, token_id=-1, step=step, error="shard s1 is unreachable")
            return result

        req = p.schemas.ChatCompletionRequest.model_validate(
            {"model": "tiny", "messages": [{"role": "user", "content": "Tell me a story"}], "max_tokens": 16,
             "temperature": 0})
        try:
            base = await inference.generate(req)
            adapter.await_token = await_token
            out = await inference.generate(req)
        finally:
            await adapter.shutdown()
        view = lambda r: (r.choices[0].message.content, r.choices[0].finish_reason,  # noqa: E731
                          r.usage.model_dump())
        return view(base), view(out), len(failed)

    outs = []
    for name in PKGS:
        p = _pkg(name)
        resumed = p.obs.metric("dnet_request_resumed_total")
        r0 = resumed.value
        outs.append(asyncio.run(go(p)) + (resumed.value - r0,))
    assert outs[1] == outs[0]
    base, out, failed, resumed = outs[1]
    assert failed == 1 and out == base and base[0] and resumed == 1


# ---- the chaos case on an in-process two-shard ring ---------------------------


def test_chaos_shard_fault_mid_decode_resumes_as_the_reference(tiny_llama_dir, resume_env):
    """shard_compute:error_at:5 (seed 11): two shard_compute calls a token,
    so call 5 is s0's half of decode step 2; the request resumes on its rid
    with the same text, usage, finish reason and counter deltas as its
    unfaulted run, on both packages."""
    from tests.torch_ring_harness import MAX_SEQ, Net, _port_shard, _ref_shard

    async def run(name):
        p = _pkg(name)
        net = Net()
        make = _port_shard if name == "dnet_tpu_torch" else _ref_shard
        nodes = [make(net, f"s{i}") for i in range(2)]
        loop = asyncio.get_running_loop()
        for rt, adapter in nodes:
            rt.start(loop)
            await adapter.start()
        await asyncio.gather(*(loop.run_in_executor(None, lambda rt=rt, ls=ls: rt.load_model_core(
            str(tiny_llama_dir), ls, max_seq=MAX_SEQ, param_dtype="float32"))
            for (rt, _), ls in zip(nodes, ([0, 1], [2, 3]))))
        nodes[0][1].configure_topology("s1")
        nodes[1][1].configure_topology("s0")
        api = p.ring.RingApiAdapter(head_addr="s0", callback_url="grpc://api:1", shard_grpc_addrs=["s0", "s1"],
                                    ring_client_factory=net.ring_client(importlib.import_module(
                                        f"{name}.transport.protocol")), max_seq_len=MAX_SEQ)
        net.api = (api, importlib.import_module(f"{name}.transport.protocol"))
        await api.start()
        m = p.inference.InferenceManager(api, request_timeout_s=30.0)
        m.tokenizer = p.tokenizer.ByteTokenizer()
        m.model_id = "tiny"
        req = p.schemas.ChatCompletionRequest.model_validate(
            {"model": "tiny", "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
             "temperature": 0.0})
        counters = [p.obs.metric("dnet_request_resumed_total"),
                    p.obs.metric("dnet_chaos_injected_total").labels(point="shard_compute")]
        try:
            base = await m.generate(req)
            before = [c.value for c in counters]
            p.chaos.install_chaos("shard_compute:error_at:5", seed=11)
            try:
                out = await m.generate(req)
            finally:
                p.chaos.clear_chaos()
            view = lambda r: (r.choices[0].message.content, r.choices[0].finish_reason,  # noqa: E731
                              r.usage.model_dump())
            return view(base), view(out), [c.value - b for c, b in zip(counters, before)]
        finally:
            await api.shutdown()
            for rt, adapter in nodes:
                await adapter.shutdown()
                rt.stop()

    ref = asyncio.run(run("dnet_tpu"))
    port = asyncio.run(run("dnet_tpu_torch"))
    assert port == ref
    base, resumed, deltas = port
    assert base[0] and resumed == base and deltas == [1, 1]


# ---- a real port ring: kill, recover, fence -----------------------------------

CHAT = {"model": "tiny", "messages": [{"role": "user", "content": "Tell me a story"}], "max_tokens": 24,
        "temperature": 0, "stream": True}


def _metric(text: str, name: str, labels: str = "") -> float:
    m = re.search(rf"^{re.escape(name)}{re.escape(labels)} ([0-9.eE+-]+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


class RecoveringRing:
    """Two port shards and an API node with --auto-recover, resume and
    rejoin on (a quarantined shard rejoins after 1 s green); s1 computes
    each frame 30 ms late (a chaos delay), so that a kill lands
    mid-stream.  Process output goes to files."""

    def __init__(self, tmp_path):
        from tests.test_torch_ring_serving import ROOT, _free_port

        self.root, self.tmp = ROOT, tmp_path
        self.env = {k: v for k, v in __import__("os").environ.items() if not k.startswith(("JAX_", "XLA_", "DNET_"))}
        self.env["PYTHONPATH"] = str(ROOT)
        self.shards = [(f"s{i}", _free_port(), _free_port()) for i in range(2)]
        self.procs = {}
        hostfile = tmp_path / "hostfile"
        hostfile.write_text("".join(f"{n} 127.0.0.1 {h} {g}\n" for n, h, g in self.shards))
        for i in range(2):
            self.start_shard(i)
        self.http = _free_port()
        api_env = dict(self.env, DNET_API_HEALTH_INTERVAL_S="0.1", DNET_API_HEALTH_FAIL_THRESHOLD="2",
                       DNET_RESILIENCE_RESUME="1", DNET_REJOIN="1", DNET_REJOIN_STABLE_S="1.0")
        self._spawn("api", api_env, "dnet_tpu_torch.cli.api", "--device", "cpu", "--host", "127.0.0.1",
                    "--http-port", str(self.http), "--grpc-port", str(_free_port()), "--hostfile", str(hostfile),
                    "--max-seq-len", str(MAX_SEQ), "--param-dtype", "bfloat16", "--request-timeout-s", "20",
                    "--auto-recover")
        self.base = f"http://127.0.0.1:{self.http}"
        for i, (_, http, _) in enumerate(self.shards):
            _wait_health(f"http://127.0.0.1:{http}", self.procs[f"s{i}"])
        _wait_health(self.base, self.procs["api"])

    def _spawn(self, key, env, module, *args):
        import sys

        log = open(self.tmp / f"{key}.log", "a")
        self.procs[key] = subprocess.Popen([sys.executable, "-m", module, *args], cwd=self.root, env=env,
                                           stdout=log, stderr=subprocess.STDOUT, text=True)

    def start_shard(self, i):
        name, http, grpc_port = self.shards[i]
        env = dict(self.env, DNET_CHAOS="shard_compute:delay:30ms") if i == 1 else self.env
        self._spawn(name, env, "dnet_tpu_torch.cli.shard", "--device", "cpu", "--host", "127.0.0.1",
                    "--http-port", str(http), "--grpc-port", str(grpc_port), "--shard-name", name,
                    "--discovery", "none")

    def get(self, path, base=None):
        return httpx.get((base or self.base) + path, timeout=10)

    def shard_base(self, i):
        return f"http://127.0.0.1:{self.shards[i][1]}"

    def stop(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        codes = {}
        for key, p in self.procs.items():
            try:
                codes[key] = p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                codes[key] = p.wait()
        return codes


@pytest.fixture(scope="module")
def rring(tiny_llama_dir, tmp_path_factory):
    r = RecoveringRing(tmp_path_factory.mktemp("rring"))
    try:
        yield r
    finally:
        r.stop()


def _stream(base, body, on_chunk=None):
    """POST a streaming chat; the raw SSE text (on_chunk(n) after the nth
    content chunk)."""
    out, n = [], 0
    with httpx.stream("POST", base + "/v1/chat/completions", json=body, timeout=120) as r:
        assert r.status_code == 200, r.read()
        for line in r.iter_lines():
            out.append(line + "\n")
            if line.startswith("data: {") and '"content"' in line:
                n += 1
                if on_chunk is not None:
                    on_chunk(n)
    return "".join(out).replace("\n\n", "\n")


def test_kill_mid_stream_recovers_and_resumes_byte_identically(rring, tiny_llama_dir):
    """POST /v1/prepare_topology profiles both CPU shards and solves a split
    that covers every layer once (the solver minimises one token's ring
    latency, so it may well put every layer on the faster shard); the ring
    is then split by hand, [0, 1] / [2, 3].  s1 is killed after the 4th
    streamed chunk: the monitor marks it down, re-solves over s0 (epoch +
    1, s0 holds every layer, s1 quarantined) and the request resumes on its
    rid, its SSE identical to the unfaulted stream's."""
    r = httpx.post(rring.base + "/v1/prepare_topology", json={"model": str(tiny_llama_dir)}, timeout=60)
    assert r.status_code == 200, r.text
    topo = r.json()["topology"]
    assert sorted(x for a in topo["assignments"] for x in a["layers"]) == [0, 1, 2, 3]
    assert topo["solution"]["k"] == 1 and all(a["mesh_tp"] == 1 and a["window_size"] == 0
                                               for a in topo["assignments"])
    r = httpx.post(rring.base + "/v1/prepare_topology_manual", timeout=30, json={
        "model": str(tiny_llama_dir),
        "assignments": [{"instance": "s0", "layers": [0, 1]}, {"instance": "s1", "layers": [2, 3]}]})
    assert r.status_code == 200, r.text
    r = httpx.post(rring.base + "/v1/load_model", json={"model": str(tiny_llama_dir)}, timeout=120)
    assert r.status_code == 200, r.text
    epoch0 = rring.get("/health").json()["epoch"]
    want = _single_process(tiny_llama_dir, [CHAT])[0][1].replace("\n\n", "\n")
    unfaulted = _stream(rring.base, CHAT)
    assert _normalize(unfaulted) == _normalize(want)

    def kill(n):
        if n == 4:
            rring.procs["s1"].send_signal(signal.SIGKILL)

    resumed = _stream(rring.base, CHAT, on_chunk=kill)
    assert _normalize(resumed) == _normalize(want)
    assert len({m for m in re.findall(r'"id": ?"([^"]*)"', resumed)}) == 1  # one rid throughout
    metrics = rring.get("/metrics").text
    assert _metric(metrics, "dnet_request_resumed_total") == 1
    assert _metric(metrics, "dnet_recovery_total", '{outcome="recovered"}') == 1
    assert _metric(metrics, "dnet_resume_replay_tokens_total") > 0
    health = rring.get("/health").json()
    assert health["status"] == "ok" and health["epoch"] == epoch0 + 1 and list(health["quarantine"]) == ["s1"]
    topo = rring.get("/v1/topology").json()["topology"]
    assert [(a["instance"], a["layers"]) for a in topo["assignments"]] == [("s0", [0, 1, 2, 3])]
    assert rring.get("/health", rring.shard_base(0)).json()["epoch"] == epoch0 + 1
    # the recovered one-shard ring serves the same bytes
    assert _normalize(_stream(rring.base, CHAT)) == _normalize(want)


def test_stale_epoch_frame_is_fenced_and_counted(rring):
    """A frame minted under the fenced epoch, sent to s0 over gRPC, is
    refused (NACK) and counted by kind on s0."""
    from dnet_tpu_torch.transport.grpc_transport import RingClient
    from dnet_tpu_torch.transport.protocol import ActivationFrame

    epoch = rring.get("/health", rring.shard_base(0)).json()["epoch"]
    before = _metric(rring.get("/metrics", rring.shard_base(0)).text, "dnet_stale_epoch_rejected_total",
                     '{kind="frame"}')

    async def send():
        client = RingClient(f"127.0.0.1:{rring.shards[0][2]}")
        try:
            call = client.channel.unary_unary(
                "/dnet.DnetRing/SendActivation", request_serializer=lambda m: m.to_bytes(),
                response_deserializer=__import__("dnet_tpu_torch.transport.protocol", fromlist=["x"]).StreamAck
                .from_bytes)
            return await call(ActivationFrame(nonce="zombie", seq=0, layer_id=-1, pos=0, dtype="tokens",
                                              shape=(1, 1), payload=b"\x01\x00\x00\x00", epoch=epoch - 1),
                              timeout=10)
        finally:
            await client.close()

    ack = asyncio.run(send())
    assert not ack.ok and ack.message == f"stale epoch: frame carries epoch {epoch - 1}, holder is at epoch {epoch}"
    after = _metric(rring.get("/metrics", rring.shard_base(0)).text, "dnet_stale_epoch_rejected_total",
                    '{kind="frame"}')
    assert after - before == 1


def _snapshot(rring):
    """(health, topology, rejoins) read between two equal epochs, so that no
    rejoin attempt lands between the reads."""
    for _ in range(50):
        health = rring.get("/health").json()
        topo = rring.get("/v1/topology").json()["topology"]
        rejoins = _metric(rring.get("/metrics").text, "dnet_shard_rejoins_total")
        again = rring.get("/health").json()
        if again["epoch"] == health["epoch"] == topo["epoch"] and set(again["quarantine"]) == set(health["quarantine"]):
            return health, topo, rejoins
        time.sleep(0.2)
    raise AssertionError("the topology kept changing")


def test_restarted_shard_rejoins_as_the_solver_places_it(rring, tiny_llama_dir):
    """s1, killed above, is started again.  Once it has probed green for
    DNET_REJOIN_STABLE_S the monitor re-profiles both shards, re-solves and
    reloads: a recovery round is counted and the epoch goes up on the API
    and on every placed shard; every layer is covered once, in contiguous
    ranges; s1 has left quarantine (one rejoin counted) if the solver
    placed it, and is still quarantined (deferred) if it did not; and the
    ring serves bytes identical to the single-process server's."""
    rounds = lambda: sum(float(v) for v in re.findall(  # noqa: E731
        r"^dnet_recovery_total\{[^}]*\} ([0-9.eE+-]+)$", rring.get("/metrics").text, re.M))
    rounds0, epoch0 = rounds(), rring.get("/health").json()["epoch"]
    assert list(rring.get("/health").json()["quarantine"]) == ["s1"]
    rring.start_shard(1)
    _wait_health(rring.shard_base(1), rring.procs["s1"])
    deadline = time.monotonic() + 90
    while rounds() == rounds0:
        assert time.monotonic() < deadline, "no rejoin round within 90 s"
        time.sleep(0.2)
    health, topo, rejoins = _snapshot(rring)
    assert health["status"] == "ok" and health["epoch"] > epoch0
    layers = [a["layers"] for a in topo["assignments"]]
    assert sorted(x for ls in layers for x in ls) == [0, 1, 2, 3]
    assert all(ls == list(range(ls[0], ls[-1] + 1)) for ls in layers)
    placed = {a["instance"] for a in topo["assignments"]}
    assert placed | set(health["quarantine"]) == {"s0", "s1"} and not placed & set(health["quarantine"])
    assert (rejoins >= 1) == ("s1" in placed)
    for i in (0, 1):
        if f"s{i}" in placed:
            assert rring.get("/health", rring.shard_base(i)).json()["epoch"] == health["epoch"]
    want = _single_process(tiny_llama_dir, [CHAT])[0][1].replace("\n\n", "\n")
    assert _normalize(_stream(rring.base, CHAT)) == _normalize(want)
