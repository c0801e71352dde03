"""Bounded admission: the port's AdmissionController and HTTP front door
against dnet_tpu's.

A burst beyond the slots and the queue is shed with 429 + Retry-After on
both servers, with the same error body, and the adapter never sees a shed
request; the controller's cases (queue full, queue timeout, FIFO handoff,
deadlines, the service-rate estimate, drain, capacity changes, a cancelled
waiter) run on the same schedule against both controllers and must give
equal outcomes; a streamed request shed at admission is a real 429; and a
port server process drains on SIGTERM: its in-flight stream finishes, new
work gets 503 and /health reads "draining".
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

PACKAGES = ("dnet_tpu", "dnet_tpu_torch")
REPO = Path(__file__).resolve().parents[1]

CHAT = {
    "model": "tiny",
    "messages": [{"role": "user", "content": "Hello there"}],
    "max_tokens": 6,
    "temperature": 0,
}


def _mods(pkg):
    """(controller module, obs.metric) of one package."""
    import importlib

    return importlib.import_module(f"{pkg}.admission.controller"), importlib.import_module(f"{pkg}.obs").metric


def _rejected(metric, reason):
    return metric("dnet_admit_rejected_total").labels(reason=reason).value


# ---- the controller's cases: each returns what it observed ----------------


async def case_immediate_admission_and_release(ctl, metric):
    c = ctl.AdmissionController(2, queue_depth=2, queue_timeout_s=5.0)
    s1, s2 = await c.acquire(), await c.acquire()
    seen = [c.active, c.queued]
    s1.release()
    s2.release()
    return seen + [c.active]


async def case_queue_full_sheds_with_retry_after(ctl, metric):
    c = ctl.AdmissionController(1, queue_depth=2, queue_timeout_s=5.0)
    before = _rejected(metric, "queue_full")
    s1 = await c.acquire()
    waiters = [asyncio.ensure_future(c.acquire()) for _ in range(2)]
    await asyncio.sleep(0.01)
    queued = c.queued
    with pytest.raises(ctl.AdmissionRejected) as ei:
        await c.acquire()
    s1.release()
    for w in waiters:
        (await w).release()
    return [queued, ei.value.reason, str(ei.value), ei.value.retry_after_s,
            _rejected(metric, "queue_full") - before, c.active, c.queued]


async def case_queue_timeout_sheds(ctl, metric):
    c = ctl.AdmissionController(1, queue_depth=2, queue_timeout_s=0.05)
    before = _rejected(metric, "queue_timeout")
    s1 = await c.acquire()
    with pytest.raises(ctl.AdmissionRejected) as ei:
        await c.acquire()
    s1.release()
    return [ei.value.reason, str(ei.value), _rejected(metric, "queue_timeout") - before]


async def case_fifo_handoff_order(ctl, metric):
    c = ctl.AdmissionController(1, queue_depth=4, queue_timeout_s=5.0)
    s1 = await c.acquire()
    order = []

    async def waiter(i):
        slot = await c.acquire()
        order.append(i)
        await asyncio.sleep(0.005)
        slot.release()

    tasks = []
    for i in range(3):
        tasks.append(asyncio.ensure_future(waiter(i)))
        await asyncio.sleep(0.001)  # a fixed arrival order
    s1.release()
    await asyncio.gather(*tasks)
    return order


async def case_deadline_already_expired_rejects(ctl, metric):
    c = ctl.AdmissionController(1, queue_depth=2, queue_timeout_s=5.0)
    stage = metric("dnet_deadline_exceeded_total").labels(stage="admission")
    before, stage_before = _rejected(metric, "deadline"), stage.value
    with pytest.raises(ctl.AdmissionRejected) as ei:
        await c.acquire(ctl.Deadline(time.time() - 1.0))
    return [ei.value.reason, str(ei.value), _rejected(metric, "deadline") - before, stage.value - stage_before]


async def case_estimated_wait_beyond_deadline_sheds_at_arrival(ctl, metric):
    c = ctl.AdmissionController(1, queue_depth=8, queue_timeout_s=5.0)
    c._observe_service(10.0)  # 10 s a request observed
    s1 = await c.acquire()
    w = asyncio.ensure_future(c.acquire())  # position 0: 10 s
    await asyncio.sleep(0.01)
    with pytest.raises(ctl.AdmissionRejected) as ei:
        await c.acquire(ctl.Deadline.after(0.5))
    est = c.estimated_wait_s(1)
    s1.release()
    (await w).release()
    # the message carries the seconds left, which differ by the clock
    return [ei.value.reason, str(ei.value).split(" exceeds")[0], ei.value.retry_after_s, est]


async def case_queue_wait_bounded_by_deadline(ctl, metric):
    c = ctl.AdmissionController(1, queue_depth=2, queue_timeout_s=30.0)
    s1 = await c.acquire()
    before = _rejected(metric, "deadline")
    with pytest.raises(ctl.AdmissionRejected) as ei:
        await c.acquire(ctl.Deadline.after(0.05))
    s1.release()
    return [ei.value.reason, str(ei.value), _rejected(metric, "deadline") - before]


async def case_cancelled_waiter_leaks_no_slot(ctl, metric):
    c = ctl.AdmissionController(1, queue_depth=2, queue_timeout_s=5.0)
    s1 = await c.acquire()
    w = asyncio.ensure_future(c.acquire())
    await asyncio.sleep(0.01)
    w.cancel()
    await asyncio.sleep(0.01)
    s1.release()
    seen = [c.active, c.queued]
    (await c.acquire()).release()  # the slot is still grantable
    return seen + [c.active]


async def case_drain_sheds_new_and_queued_then_drains(ctl, metric):
    c = ctl.AdmissionController(1, queue_depth=4, queue_timeout_s=5.0)
    s1 = await c.acquire()
    queued = asyncio.ensure_future(c.acquire())
    await asyncio.sleep(0.01)
    before = _rejected(metric, "draining")
    c.begin_drain()
    out = []
    for coro in (queued, c.acquire()):
        with pytest.raises(ctl.AdmissionRejected) as ei:
            await coro
        out += [ei.value.reason, str(ei.value)]

    async def finish():
        await asyncio.sleep(0.05)
        s1.release()

    asyncio.ensure_future(finish())
    drained = await c.wait_drained(2.0)
    return out + [_rejected(metric, "draining") - before, metric("dnet_drain_state").value, drained, c.active]


async def case_drain_deadline_bounds_stuck_requests(ctl, metric):
    c = ctl.AdmissionController(1, queue_depth=2, queue_timeout_s=5.0)
    s1 = await c.acquire()
    c.begin_drain()
    drained = await c.wait_drained(0.05)
    s1.release()
    return [drained, c.active]


async def case_capacity_raise_wakes_waiters(ctl, metric):
    c = ctl.AdmissionController(4, queue_depth=4, queue_timeout_s=5.0)
    c.set_capacity(1)
    s1 = await c.acquire()
    waiters = [asyncio.ensure_future(c.acquire()) for _ in range(3)]
    await asyncio.sleep(0.01)
    seen = [c.capacity, c.active, c.queued]
    c.set_capacity(None)  # back to 4: every waiter runs now
    slots = [await w for w in waiters]
    seen += [c.capacity, c.active, c.queued]
    for s in slots + [s1]:
        s.release()
    return seen + [c.active]


CASES = {name: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_controller_case_equal_across_packages(case):
    out = {pkg: asyncio.run(CASES[case](*_mods(pkg))) for pkg in PACKAGES}
    assert out["dnet_tpu_torch"] == out["dnet_tpu"]


# ---- the HTTP front door ----------------------------------------------------


@pytest.fixture
def admit_env(monkeypatch):
    """One slot and a queue of two, on both servers."""
    monkeypatch.setenv("DNET_API_WARM_ON_LOAD", "0")
    monkeypatch.setenv("DNET_ADMIT_QUEUE_DEPTH", "2")
    monkeypatch.setenv("DNET_ADMIT_QUEUE_TIMEOUT_S", "30")
    monkeypatch.delenv("DNET_REQUEST_DEADLINE_S", raising=False)
    reset_settings_cache()
    yield
    reset_settings_cache()


def _server(pkg):
    """(app, inference manager) of one package's single-process server,
    one slot."""
    import importlib

    http = importlib.import_module(f"{pkg}.api.http")
    inference_mod = importlib.import_module(f"{pkg}.api.inference")
    manager_mod = importlib.import_module(f"{pkg}.api.model_manager")
    inference = inference_mod.InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=1)
    kw = {"device": "cpu"} if pkg == "dnet_tpu_torch" else {}
    manager = manager_mod.LocalModelManager(inference, max_seq=64, param_dtype="float32", **kw)
    return http.ApiHTTPServer(inference, manager).app, inference


def _gate_adapter(inference):
    """Hold every request's prefill until the gate opens, and note the
    nonces the adapter saw."""
    adapter = inference.adapter
    gate, seen = asyncio.Event(), []
    send = adapter.send_tokens

    async def gated(nonce, ids, decoding, step, budget=None):
        if step == 0:
            seen.append(nonce)
            await gate.wait()
        return await send(nonce, ids, decoding, step, budget=budget)

    adapter.send_tokens = gated
    return gate, seen


async def _burst(pkg, model_dir, n, stream=False):
    """n requests at once against one slot and a queue of two; the gate
    opens once the burst has settled.  Returns (status, Retry-After, body)
    per request, the nonces the adapter saw, and the queue_full counter's
    move."""
    app, inference = _server(pkg)
    metric = _mods(pkg)[1]
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        assert r.status == 200, await r.text()
        gate, seen = _gate_adapter(inference)
        before = _rejected(metric, "queue_full")
        posts = [asyncio.ensure_future(client.post("/v1/chat/completions", json=dict(CHAT, stream=stream)))
                 for _ in range(n)]
        for _ in range(500):
            if inference.admission.queued == 2 and _rejected(metric, "queue_full") - before >= n - 3:
                break
            await asyncio.sleep(0.01)
        gate.set()
        out = []
        for resp in await asyncio.gather(*posts):
            body = await resp.text()
            if resp.status != 200:
                body = json.loads(body)
            out.append((resp.status, resp.headers.get("Retry-After"), body if resp.status != 200 else None))
        return out, seen, _rejected(metric, "queue_full") - before
    finally:
        await client.close()


@pytest.mark.parametrize("stream", [False, True], ids=["aggregate", "streamed"])
def test_burst_sheds_exactly_beyond_queue_and_slots(tiny_llama_dir, admit_env, stream):
    """One slot, a queue of two and a burst of six: three answers and three
    429s with Retry-After and the reference's body on both servers (a
    streamed request's rejection is a real 429 too, not an error inside a
    200 stream), and the adapter sees only the three admitted requests."""
    out = {pkg: asyncio.run(_burst(pkg, tiny_llama_dir, 6, stream)) for pkg in PACKAGES}
    for pkg, (answers, seen, shed) in out.items():
        statuses = sorted(a[0] for a in answers)
        assert statuses == [200, 200, 200, 429, 429, 429], (pkg, statuses)
        for status, retry_after, body in answers:
            if status == 429:
                assert int(retry_after) >= 1
                assert body == {"error": {"message": "admission queue full (2 waiting, 1 executing)",
                                          "type": "rate_limit_exceeded"}}
        assert len(seen) == 3 and shed == 3
    assert sorted(out["dnet_tpu_torch"][0], key=str) == sorted(out["dnet_tpu"][0], key=str)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_sigterm_drains_in_flight_stream_and_refuses_new_work(tiny_llama_dir, tmp_path):
    """A port server process told to stop drains: /health reads
    "draining", a new request gets 503 + Retry-After, and the stream in
    flight runs to its last token before the process exits 0."""
    port = _free_port()
    # one torch thread: the tiny model's steps stay short on a loaded machine
    env = dict(os.environ, DNET_DRAIN_DEADLINE_S="600", HOME=str(tmp_path), PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dnet_tpu_torch.cli.api", "--model", str(tiny_llama_dir), "--device", "cpu",
         "--host", "127.0.0.1", "--http-port", str(port), "--max-seq-len", "512", "--param-dtype", "float32"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            try:
                if _get(base + "/health")[1].get("model"):
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stdout.read().decode()
            time.sleep(0.1)
        # a long stream: EOS banned, so it runs to max_tokens
        body = dict(CHAT, stream=True, max_tokens=300, logit_bias={"257": -100})
        req = urllib.request.Request(base + "/v1/chat/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        stream = urllib.request.urlopen(req, timeout=120)
        first = stream.readline()
        assert first.startswith(b"data: "), first
        proc.send_signal(signal.SIGTERM)
        for _ in range(100):
            status, health = _get(base + "/health")
            if health["status"] == "draining":
                break
            time.sleep(0.02)
        assert health["status"] == "draining" and health["admission"]["active"] == 1
        new = urllib.request.Request(base + "/v1/chat/completions", data=json.dumps(CHAT).encode(),
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(new, timeout=30)
        assert ei.value.code == 503 and int(ei.value.headers["Retry-After"]) >= 1
        assert json.loads(ei.value.read())["error"]["type"] == "service_unavailable"
        rest = stream.read().decode()
        assert rest.rstrip().endswith("data: [DONE]")
        final = json.loads(rest.strip().split("\n\n")[-2][len("data: "):])
        assert final["choices"][0]["finish_reason"] == "length"
        assert final["usage"]["completion_tokens"] == 300
        assert proc.wait(timeout=120) == 0, proc.stdout.read().decode()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
