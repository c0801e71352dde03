"""The port's observability layer (dnet_tpu_torch/obs/) against dnet_tpu's.

- A fresh registry's exposition has the reference's family names, TYPEs,
  HELP strings and label sets; the one stated exception is the `fn` values
  of dnet_jit_compiles_total (the port's CUDA sources, not jitted entry
  points).
- The reference's own cases for the registry (tests/test_obs_metrics.py),
  the SLO windows (tests/test_obs_slo.py) and the critical-path ledger
  (tests/subsystems/test_critical_path.py) run unchanged against the
  port's modules: each case function is called with the port's names
  bound in place of the reference's.
- Both servers serve the same sequence on the tiny llama checkpoint
  (single-sequence greedy, streamed, profiled and shed requests; a
  concurrent burst on batched slots; sequential requests on paged slots
  with obs on; a two-turn DNET_SCHED=1 conversation through the paged
  prefix cache).  The deterministic counters, the histogram counts, a
  request's span names in order, the profile's segment keys and the event
  names and trace tracks must then be equal, and with obs off the port's
  device fence is never called.
"""

import asyncio
import importlib
import re
import types

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dnet_tpu.config import reset_settings_cache

pytestmark = [pytest.mark.api, pytest.mark.http]

PACKAGES = ("dnet_tpu", "dnet_tpu_torch")


# ---- the exposition --------------------------------------------------------


def _families(text: str) -> dict:
    """family -> (TYPE, HELP, sorted label sets of its samples)."""
    fams: dict = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, help_text = line[7:].split(" ", 1)
            fams.setdefault(name, {})["help"] = help_text
        elif line.startswith("# TYPE "):
            name, kind = line[7:].split(" ", 1)
            fams.setdefault(name, {})["type"] = kind
        elif line:
            sample = line.split(" ")[0]
            base = re.sub(r"_(bucket|sum|count)$", "", sample.split("{")[0])
            if base not in fams:
                base = sample.split("{")[0]
            labels = re.sub(r',?le="[^"]*"', "", sample[len(sample.split("{")[0]):])
            fams[base].setdefault("labels", set()).add(labels)
    return {k: (v["type"], v["help"], sorted(v.get("labels", ()))) for k, v in fams.items()}


def _fresh_exposition(pkg: str) -> str:
    obs = importlib.import_module(f"{pkg}.obs")
    reg = obs.MetricsRegistry()
    obs._register_core(reg)
    return reg.expose()


def test_exposition_matches_the_reference_family_for_family():
    ref, port = (_families(_fresh_exposition(pkg)) for pkg in PACKAGES)
    assert list(port) == list(ref)  # same families, same order
    from dnet_tpu_torch.kernels.build import SOURCES
    from dnet_tpu_torch.obs.phases import KERNEL_SOURCES

    for name in ref:
        if name == "dnet_jit_compiles_total":
            assert port[name][:2] == ref[name][:2]
            assert port[name][2] == sorted(f'{{fn="{s}"}}' for s in KERNEL_SOURCES)
            assert sorted(KERNEL_SOURCES) == sorted(SOURCES)
        else:
            assert port[name] == ref[name], name


# ---- the reference's unit cases on the port's modules ----------------------


def _rebound(module: str, fn_name: str, names: dict):
    """The reference test `module.fn_name` with `names` bound in place of
    the reference's globals."""
    ref = importlib.import_module(module)
    fn = getattr(ref, fn_name)
    return types.FunctionType(fn.__code__, {**fn.__globals__, **names}, fn.__name__, fn.__defaults__)


def _port_names(module: str) -> dict:
    mod = importlib.import_module(module)
    return {k: v for k, v in vars(mod).items() if not k.startswith("__")}


METRICS_CASES = [
    "test_counter_math_and_monotonicity", "test_gauge_set_inc_dec", "test_histogram_bucket_edges_inclusive",
    "test_histogram_observe_n_matches_n_observes", "test_histogram_percentile_interpolation",
    "test_default_ms_buckets_are_increasing", "test_label_cardinality_cap_collapses_to_overflow",
    "test_labels_validation_and_idempotent_registration", "test_bad_names_and_empty_help_rejected",
    "test_exposition_golden", "test_reset_keeps_handles_valid",
]


@pytest.mark.parametrize("case", METRICS_CASES)
def test_registry_math_case_on_the_port(case):
    _rebound("tests.test_obs_metrics", case, _port_names("dnet_tpu_torch.obs.metrics"))()


SLO_CASES = [
    "test_empty_window_never_burns", "test_exact_target_boundary_is_meeting_the_slo",
    "test_zero_window_disables_instead_of_crashing", "test_disabled_target_never_burns",
    "test_window_expiry_forgives_old_pain", "test_availability_boundary_and_burn",
    "test_rolling_window_percentile_nearest_rank", "test_rolling_window_bounds_memory",
    "test_snapshot_updates_gauges", "test_p99_gauges_and_snapshot_payload",
]


@pytest.mark.parametrize("case", SLO_CASES)
def test_slo_window_case_on_the_port(case):
    from dnet_tpu_torch.obs import metric, reset_obs

    names = dict(_port_names("dnet_tpu_torch.obs.slo"), metric=metric, reset_obs=reset_obs)
    _rebound("tests.test_obs_slo", case, names)()


CRITICAL_PATH_CASES = [
    "test_decompose_partitions_window_most_specific_wins", "test_decompose_gaps_land_in_other",
    "test_decompose_shard_node_remaps_compute", "test_decompose_admission_wait_extends_window_left",
    "test_decompose_degenerate_timelines",
]


@pytest.mark.parametrize("case", CRITICAL_PATH_CASES)
def test_critical_path_case_on_the_port(case):
    names = dict(_port_names("dnet_tpu_torch.obs.phases"), **_port_names("dnet_tpu_torch.obs.critical_path"))
    _rebound("tests.subsystems.test_critical_path", case, names)()


# ---- the serving comparison ------------------------------------------------

CHAT = {"model": "tiny", "messages": [{"role": "user", "content": "Hello there, tiny model"}],
        "max_tokens": 6, "temperature": 0}
BURST = ["Hi", "A quick brown fox", "x" * 30, "mid prompt here"]
PAGED = {"DNET_KV_PAGED": "1", "DNET_KV_BLOCK_TOKENS": "8"}
SCHED = {"DNET_SCHED": "1", "DNET_KV_PAGED": "1", "DNET_KV_RAGGED": "1", "DNET_KV_BLOCK_TOKENS": "8",
         "DNET_API_PREFIX_CACHE": "4"}
ENV_KEYS = ("DNET_SCHED", "DNET_KV_PAGED", "DNET_KV_RAGGED", "DNET_KV_BLOCK_TOKENS", "DNET_API_PREFIX_CACHE",
            "DNET_OBS_ENABLED")


def _app(pkg: str, slots: int, prefix_cache: int = 0):
    http = importlib.import_module(f"{pkg}.api.http")
    inference_mod = importlib.import_module(f"{pkg}.api.inference")
    manager_mod = importlib.import_module(f"{pkg}.api.model_manager")
    inference = inference_mod.InferenceManager(adapter=None, request_timeout_s=120.0, max_concurrent=8)
    # the port reads DNET_API_PREFIX_CACHE at load, the reference's manager
    # takes it from its CLI
    kw = {"device": "cpu"} if pkg == "dnet_tpu_torch" else {"prefix_cache": prefix_cache}
    manager = manager_mod.LocalModelManager(inference, max_seq=128, param_dtype="float32", batch_slots=slots, **kw)
    return http.ApiHTTPServer(inference, manager).app


def _samples(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


async def _pass(pkg, model_dir, slots, env, monkeypatch, fn):
    """One server of `pkg` under `env`: load, run `fn(client)`, close."""
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    reset_settings_cache()
    client = TestClient(TestServer(_app(pkg, slots, int(env.get("DNET_API_PREFIX_CACHE", 0)))))
    await client.start_server()
    try:
        r = await client.post("/v1/load_model", json={"model": str(model_dir)})
        assert r.status == 200, await r.text()
        return await fn(client)
    finally:
        await client.close()


async def _chat(client, body, status=200):
    resp = await client.post("/v1/chat/completions", json=body)
    raw = await resp.text()
    assert resp.status == status, raw
    return raw


def _sequence(pkg, model_dir, monkeypatch):
    """The whole sequence on `pkg`'s server; returns what the test reads."""
    obs = importlib.import_module(f"{pkg}.obs")
    obs.reset_obs()
    out = {}

    async def single(client):
        raw = await _chat(client, CHAT)
        out["rid"] = re.search(r'"id": ?"([^"]+)"', raw).group(1)
        await _chat(client, dict(CHAT, stream=True))
        prof = await _chat(client, dict(CHAT, profile=True))
        import json

        out["profile"] = json.loads(prof)["metrics"]
        # shed at the gate: its deadline passed before it arrived
        await _chat(client, dict(CHAT, deadline_s=1e-6), status=429)
        out["timeline"] = await (await client.get(f"/v1/debug/timeline/{out['rid']}")).json()

    async def burst(client):
        await asyncio.gather(*(_chat(client, dict(CHAT, messages=[{"role": "user", "content": p}], stream=True))
                               for p in BURST))

    async def paged_obs_on(client):
        for p in BURST[:2]:
            await _chat(client, dict(CHAT, messages=[{"role": "user", "content": p}], stream=True))

    async def two_turns(client):
        first = [{"role": "user", "content": "Tell me about a quick brown fox"}]
        raw = await _chat(client, dict(CHAT, messages=first))
        import json

        reply = json.loads(raw)["choices"][0]["message"]["content"]
        await _chat(client, dict(CHAT, messages=first + [{"role": "assistant", "content": reply},
                                                         {"role": "user", "content": "and then?"}]))
        out["events"] = await (await client.get("/v1/debug/events")).json()
        out["trace"] = await (await client.get("/v1/debug/trace")).json()
        out["metrics"] = _samples(await (await client.get("/metrics")).text())

    fences = None
    if pkg == "dnet_tpu_torch":
        from dnet_tpu_torch.obs.jit import fence_calls

        fences = fence_calls()
    asyncio.run(_pass(pkg, model_dir, 1, {}, monkeypatch, single))
    asyncio.run(_pass(pkg, model_dir, 4, {}, monkeypatch, burst))
    if fences is not None:
        out["fences_obs_off"] = fence_calls() - fences
    asyncio.run(_pass(pkg, model_dir, 4, dict(PAGED, DNET_OBS_ENABLED="1"), monkeypatch, paged_obs_on))
    asyncio.run(_pass(pkg, model_dir, 4, SCHED, monkeypatch, two_turns))
    return out


@pytest.fixture(scope="module")
def sequences(tiny_llama_dir):
    mp = pytest.MonkeyPatch()
    mp.setenv("DNET_API_WARM_ON_LOAD", "0")
    mp.setenv("DNET_FLASH_INTERPRET", "1")
    mp.delenv("DNET_REQUEST_DEADLINE_S", raising=False)
    mp.delenv("DNET_PROFILE", raising=False)
    try:
        yield {pkg: _sequence(pkg, tiny_llama_dir, mp) for pkg in PACKAGES}
    finally:
        mp.undo()
        reset_settings_cache()


DETERMINISTIC = re.compile(
    r"^(dnet_requests_total|dnet_request_errors_total|dnet_tokens_generated_total|dnet_admit_admitted_total"
    r"|dnet_admit_rejected_total\{.*|dnet_kv_cache_(hits|misses|stores)_total\{.*"
    r"|dnet_sched_preemptions_total\{.*|dnet_events_total\{.*"
    r"|dnet_(ttft_ms|prefill_ms|decode_step_ms)_count|dnet_step_phase_ms_count\{.*)$"
)


def test_deterministic_counters_and_histogram_counts_equal(sequences):
    ref, port = (sequences[p]["metrics"] for p in PACKAGES)
    keys = sorted(k for k in ref if DETERMINISTIC.match(k))
    assert {k: port.get(k) for k in keys} == {k: ref[k] for k in keys}
    # the sequence moved what it exercises
    assert port["dnet_requests_total"] == 11
    assert port['dnet_admit_rejected_total{reason="deadline"}'] == 1
    assert port['dnet_kv_cache_hits_total{cache="prefix"}'] >= 1
    for phase in ("kv_gather", "compute", "kv_scatter", "sample"):
        assert port[f'dnet_step_phase_ms_count{{phase="{phase}"}}'] > 0


def test_obs_off_makes_no_device_fence(sequences):
    assert sequences["dnet_tpu_torch"]["fences_obs_off"] == 0


def test_timeline_spans_and_profile_segments_equal(sequences):
    ref, port = (sequences[p] for p in PACKAGES)
    names = [[s["name"] for s in seq["timeline"]["spans"]] for seq in (ref, port)]
    assert names[1] == names[0]
    assert sorted(port["timeline"]["critical_path"]["segments_ms"]) == sorted(
        ref["timeline"]["critical_path"]["segments_ms"])
    assert sorted(port["profile"]) == sorted(ref["profile"])
    assert sorted(port["profile"]["critical_path"]["segments_ms"]) == sorted(
        ref["profile"]["critical_path"]["segments_ms"])
    cp = port["profile"]["critical_path"]
    assert abs(sum(cp["segments_ms"].values()) - cp["total_ms"]) < 1e-2


def test_events_and_trace_tracks_equal(sequences):
    ref, port = (sequences[p] for p in PACKAGES)
    assert sorted({e["name"] for e in port["events"]["events"]}) == sorted(
        {e["name"] for e in ref["events"]["events"]})

    def tracks(trace):
        return sorted({(e["ph"], e["name"], e.get("args", {}).get("name", "")) for e in trace["traceEvents"]
                       if e["ph"] == "M"})

    assert tracks(port["trace"]) == tracks(ref["trace"])
