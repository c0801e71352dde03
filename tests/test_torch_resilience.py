"""The port's chaos harness and retry policy against the reference's
(dnet_tpu/resilience/chaos.py, policy.py): the same spec grammar and parse
errors, the same fired calls and delays for a spec and a seed, the same
RPC classes, retry verdicts and backoff delays under one jitter seed."""

import asyncio
import random

import pytest

import dnet_tpu.resilience.chaos as ref_chaos
import dnet_tpu.resilience.policy as ref_policy
import dnet_tpu_torch.resilience.chaos as port_chaos
import dnet_tpu_torch.resilience.policy as port_policy
from dnet_tpu.config import reset_settings_cache

pytestmark = pytest.mark.chaos

SPECS = [
    "shard_compute:error_at:5",
    "shard_compute:error_at:2+3+9",
    "send_activation:error:0.3",
    "token_cb:delay:50ms,health_check:error:0.5",
    "rejoin:partition:3+4",
    "admit:delay:0.25s,zombie_frame:error:0.1,update_topology:error_at:1",
    "wire_encode:error:0.2, wire_decode:partition:1+2 ,fleet_dispatch:delay:2",
    "token_cb:error:0.2,token_cb:error_at:4",  # later spec wins
]
SEEDS = [0, 11, 12345]
BAD_SPECS = [
    "shard_compute:error_at",
    "nowhere:error:0.1",
    "token_cb:explode:1",
    "rejoin:partition:3",
    "rejoin:partition:0+2",
    "rejoin:partition:2+0",
    "shard_compute:error_at:x",
    "a:b:c:d",
]


@pytest.fixture(autouse=True)
def _clean_chaos():
    for mod in (ref_chaos, port_chaos):
        mod.clear_chaos()
    yield
    for mod in (ref_chaos, port_chaos):
        mod.clear_chaos()


def _schedule(mod, spec: str, seed: int, calls: int = 40):
    inj = mod.ChaosInjector(spec, seed=seed)
    return {p: [inj.decide(p) for _ in range(calls)] for p in mod.INJECTION_POINTS}


def test_declared_points_and_kinds_equal_the_reference():
    assert port_chaos.INJECTION_POINTS == ref_chaos.INJECTION_POINTS
    assert port_chaos.KINDS == ref_chaos.KINDS
    assert issubclass(port_chaos.ChaosError, ConnectionError)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("spec", SPECS)
def test_same_spec_and_seed_fire_on_the_same_calls(spec, seed):
    port = _schedule(port_chaos, spec, seed)
    assert port == _schedule(ref_chaos, spec, seed)
    assert any(act != "none" for calls in port.values() for act, _ in calls)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_the_reference_errors(spec):
    with pytest.raises(ValueError) as ref_err:
        ref_chaos.ChaosInjector(spec)
    with pytest.raises(ValueError) as port_err:
        port_chaos.ChaosInjector(spec)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("raw, want", [("50ms", 0.05), ("0.5s", 0.5), ("0.25", 0.25), ("2", 2.0)])
def test_durations_parse_as_the_reference(raw, want):
    assert port_chaos._parse_duration(raw) == ref_chaos._parse_duration(raw) == pytest.approx(want)


def test_inject_raises_delays_and_counts():
    from dnet_tpu_torch.obs import metric

    fam = metric("dnet_chaos_injected_total")
    before = {p: fam.labels(point=p).value for p in ("shard_compute", "token_cb", "admit")}
    port_chaos.install_chaos("shard_compute:error_at:2,token_cb:delay:10ms", seed=3)
    port_chaos.inject("shard_compute")  # call 1 passes
    with pytest.raises(port_chaos.ChaosError, match="chaos injected at shard_compute"):
        port_chaos.inject("shard_compute")
    port_chaos.inject("admit")  # not armed: a no-op that counts nothing
    asyncio.run(port_chaos.inject_async("token_cb"))
    after = {p: fam.labels(point=p).value for p in before}
    assert {p: after[p] - before[p] for p in before} == {"shard_compute": 1, "token_cb": 1, "admit": 0}
    port_chaos.clear_chaos()
    port_chaos.inject("shard_compute")  # cleared: inert, the env spec is not re-read


def test_armed_summary_and_startup_check_match_the_reference(monkeypatch):
    for mod in (ref_chaos, port_chaos):
        mod.install_chaos("token_cb:delay:5ms,shard_compute:error_at:3", seed=7)
    assert port_chaos.armed_summary() == ref_chaos.armed_summary() == {
        "spec": "token_cb:delay:5ms,shard_compute:error_at:3", "seed": 7,
        "points": {"shard_compute": "error_at", "token_cb": "delay"},
    }
    # a malformed DNET_CHAOS stops the server at start, naming the vocabulary
    monkeypatch.setenv("DNET_CHAOS", "shard_compute:explode:1")
    monkeypatch.setattr(port_chaos, "_active", None)
    monkeypatch.setattr(port_chaos, "_env_loaded", False)
    with pytest.raises(SystemExit, match="malformed DNET_CHAOS") as exc:
        port_chaos.validate_startup(role="shard")
    assert "declared points: send_activation" in str(exc.value)
    monkeypatch.setenv("DNET_CHAOS", "rejoin:error_at:1")
    monkeypatch.setenv("DNET_CHAOS_SEED", "9")
    monkeypatch.setattr(port_chaos, "_env_loaded", False)
    armed = port_chaos.validate_startup(role="shard")
    assert (armed.spec, armed.seed) == ("rejoin:error_at:1", 9)


# ---- the retry policy ------------------------------------------------------


class _GrpcLike(Exception):
    def __init__(self, name):
        self._name = name

    def code(self):
        return type("Code", (), {"name": self._name})()


RETRY_CASES = [
    _GrpcLike("UNAVAILABLE"), _GrpcLike("DEADLINE_EXCEEDED"), _GrpcLike("INVALID_ARGUMENT"),
    _GrpcLike("INTERNAL"), ConnectionResetError("x"), TimeoutError("x"), asyncio.TimeoutError(),
    OSError("x"), ValueError("x"), RuntimeError("x"), KeyError("x"), ref_chaos.ChaosError("x"),
    port_chaos.ChaosError("x"),
]


@pytest.mark.parametrize("exc", RETRY_CASES, ids=lambda e: type(e).__name__ + getattr(e, "_name", ""))
def test_retry_verdicts_equal_the_reference(exc):
    assert port_policy.is_retryable(exc) == ref_policy.is_retryable(exc)


@pytest.fixture
def retry_env(monkeypatch):
    def set_env(**kw):
        for k, v in kw.items():
            monkeypatch.setenv(f"DNET_RESILIENCE_{k.upper()}", str(v))
        reset_settings_cache()
        for mod in (ref_policy, port_policy):
            mod.reset_jitter_rng()

    yield set_env
    reset_settings_cache()
    for mod in (ref_policy, port_policy):
        mod.reset_jitter_rng()


@pytest.mark.parametrize("env", [{}, {"retry_attempts": 5, "retry_base_s": 0.2, "retry_max_s": 1.0},
                                 {"retry_attempts": 0, "retry_base_s": 0.5, "retry_max_s": 0.1}])
@pytest.mark.parametrize("method", ["health_check", "send_token", "load_model", "send_activation",
                                    "reset_cache", "measure_latency", "other"])
def test_policy_classes_equal_the_reference(retry_env, env, method):
    retry_env(**env)
    port, ref = port_policy.policy_for(method), ref_policy.policy_for(method)
    assert (port.max_attempts, port.base_delay_s, port.max_delay_s, port.multiplier, port.jitter) == (
        ref.max_attempts, ref.base_delay_s, ref.max_delay_s, ref.multiplier, ref.jitter)
    if method == "health_check":
        assert port.max_attempts == 1


def test_backoff_under_one_jitter_seed_equals_the_reference(retry_env):
    retry_env(retry_jitter_seed=1234, retry_attempts=6)
    port_rng, ref_rng = port_policy.jitter_rng(), ref_policy.jitter_rng()
    pol = port_policy.policy_for("send_activation")
    ref_pol = ref_policy.policy_for("send_activation")
    assert [pol.delay_s(a, port_rng) for a in range(12)] == [ref_pol.delay_s(a, ref_rng) for a in range(12)]
    assert [port_policy.RetryPolicy(jitter="none").delay_s(a, random.Random(0)) for a in range(6)] == [
        ref_policy.RetryPolicy(jitter="none").delay_s(a, random.Random(0)) for a in range(6)]


@pytest.mark.parametrize("fail_times, exc", [(2, ConnectionError("flap")), (9, ConnectionError("down")),
                                             (1, ValueError("bug"))])
def test_call_with_retry_sleeps_and_outcomes_equal_the_reference(retry_env, fail_times, exc):
    retry_env(retry_attempts=4, retry_base_s=0.1)

    def run(mod):
        sleeps, calls = [], []

        async def fn():
            calls.append(1)
            if len(calls) <= fail_times:
                raise exc
            return "ok"

        async def sleep(d):
            sleeps.append(d)

        async def go():
            try:
                return await mod.call_with_retry(fn, method="reset_cache", rng=random.Random(5), sleep=sleep)
            except Exception as e:  # the last error propagates unchanged
                return type(e).__name__, str(e)

        return asyncio.run(go()), sleeps, len(calls)

    assert run(port_policy) == run(ref_policy)
