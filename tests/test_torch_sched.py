"""The port's scheduler (dnet_tpu_torch/sched/) against dnet_tpu's, on fakes.

The reference's policy, queue and step cases (tests/subsystems/test_sched.py)
run on both packages' modules with the same fake engines: every case holds
its expectations in each package (`test_case[<package>-<case>]`), and the
TickPlans, TickResults and queue states the two packages produce from the
same inputs are equal (`test_case_equal_across_packages[<case>]`).  The
fakes carry just the engine surface the loop-side policy (slots, pool) and
the compute-side tick (slot, pool and session calls) touch."""

import importlib
from types import SimpleNamespace

import pytest

PACKAGES = ("dnet_tpu", "dnet_tpu_torch")


def _modules(pkg):
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        pkg=pkg, policy=mod("sched.policy"), queue=mod("sched.queue"), kinds=mod("sched.kinds"),
        step=mod("sched.step"), engine=mod("sched.engine"), types=mod("core.types"), kv=mod("kv"),
    )


# ---- fakes -------------------------------------------------------------


class FakePool:
    def __init__(self, free: int) -> None:
        self.free = free

    def can_cover(self, n: int) -> bool:
        return n <= self.free


class FakeCfg:
    block_tokens = 8

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_tokens)


class FakeEngine:
    max_seq = 256

    def __init__(self, slots: int = 4, free_blocks=None) -> None:
        self.slots = slots
        self.kv_pool = FakePool(free_blocks) if free_blocks is not None else None
        self._kv_cfg = FakeCfg()


class _Table:
    def __init__(self, blocks):
        self.blocks = list(blocks)


class FakeStepEngine:
    """The surface execute_tick touches, with scriptable pool starvation
    (raising the package's own KVPoolExhausted)."""

    max_seq = 256
    slots = 4

    def __init__(self, m, fail_prefill=(), pool_free=100):
        self.m = m
        self.kv_pool = FakePool(pool_free)
        self._kv_cfg = FakeCfg()
        self.slot_of = {}
        self.pos = [0] * self.slots
        self._tables = [None] * self.slots
        self.eng = SimpleNamespace(sessions={})
        self.fail_prefill = set(fail_prefill)
        self.stored = []
        self.ended = []

    def occupy(self, nonce, committed=8, blocks=1):
        slot = len(self.slot_of)
        self.slot_of[nonce] = slot
        self.pos[slot] = committed
        self._tables[slot] = _Table(range(blocks))
        return slot

    def reserve_slot(self, nonce):
        self.occupy(nonce, committed=0, blocks=0)

    def seed_from_prefix(self, nonce, ids, seed=None):
        return 0

    def prefill_chunk(self, nonce, ids, seed=None):
        if nonce in self.fail_prefill:
            raise self.m.kv.KVPoolExhausted(2, 0, 8)
        self.pos[self.slot_of[nonce]] += len(ids)
        return "logits"

    def store_prefix(self, nonce, ids):
        self.stored.append(nonce)

    def adopt_prefilled(self, nonce, logits, decoding):
        return f"sample-{nonce}"

    def abandon_prefill(self, nonce):
        self.slot_of.pop(nonce, None)

    def end_session(self, nonce):
        self.ended.append(nonce)
        self.slot_of.pop(nonce, None)

    def decode_batch(self, requests, budgets=None):
        return {n: f"tok-{n}" for n in requests}, {}


def _add(m, queue, nonce, n_prompt, deadline=None, step=0):
    req = queue.add(nonce, list(range(n_prompt)), m.types.DecodingParams(), deadline_ts=deadline)
    req.pending_step = step
    return req


def _plan(plan) -> dict:
    """A TickPlan as plain data (DecodingParams are each package's own)."""
    return {
        "prefills": [(c.nonce, c.ids, c.start, c.end, c.first, c.last, c.pending_step, c.seed, c.victims)
                     for c in plan.prefills],
        "decode": {n: tok for n, (tok, _dec) in plan.decode.items()},
        "budgets": plan.budgets, "steps": plan.steps, "ids": plan.ids, "victims": plan.victims,
        "admitted": plan.admitted, "prefill_tokens": plan.prefill_tokens, "empty": plan.empty(),
    }


def _result(res) -> dict:
    return {k: getattr(res, k) for k in ("decode_results", "adopted", "progress", "errors", "preempted",
                                         "requeued", "prefill_tokens", "decode_lanes")}


def _states(queue) -> dict:
    return {r.nonce: (r.state, r.prefilled, r.preemptions, r.starved, r.pending_step)
            for r in sorted(queue._reqs.values(), key=lambda r: r.arrival)}


# ---- policy: packing ----------------------------------------------------


def case_decode_first_then_prefill_remainder(m):
    """Budget 10: 2 decode lanes take 1 token each, the PREFILLING request
    only the 8 left."""
    q = m.queue.SchedQueue()
    for n in ("d1", "d2"):
        _add(m, q, n, 4, step=3).state = m.kinds.STATE_DECODING
    p = _add(m, q, "p1", 64)
    p.state = m.kinds.STATE_PREFILLING
    plan = m.policy.SchedulerPolicy(token_budget=10, prefill_chunk=256).plan(q, FakeEngine())
    assert set(plan.decode) == {"d1", "d2"}
    assert len(plan.prefills) == 1 and plan.prefills[0].nonce == "p1"
    assert plan.prefill_tokens == 8 and not plan.prefills[0].last
    return [_plan(plan), _states(q)]


def case_prefill_segments_bounded_by_chunk(m):
    q = m.queue.SchedQueue()
    p = _add(m, q, "p1", 100)
    p.state = m.kinds.STATE_PREFILLING
    plan = m.policy.SchedulerPolicy(token_budget=1000, prefill_chunk=16).plan(q, FakeEngine())
    assert plan.prefills[0].end - plan.prefills[0].start == 16
    p.prefilled = 96
    plan2 = m.policy.SchedulerPolicy(token_budget=1000, prefill_chunk=16).plan(q, FakeEngine())
    assert plan2.prefills[0].last and plan2.prefills[0].end == 100
    return [_plan(plan), _plan(plan2)]


def case_decode_without_pending_step_not_dispatched(m):
    q = m.queue.SchedQueue()
    _add(m, q, "d1", 4, step=1).state = m.kinds.STATE_DECODING
    q.add("d2", [1, 2], m.types.DecodingParams()).state = m.kinds.STATE_DECODING  # no pending step
    plan = m.policy.SchedulerPolicy(64, 16).plan(q, FakeEngine())
    assert set(plan.decode) == {"d1"} and plan.ids == {}
    starved = m.policy.SchedulerPolicy(64, 16).plan(q, FakeEngine(free_blocks=0))
    assert set(starved.ids) == {"d1", "d2"}  # under pool pressure the replay ids ride along
    return [_plan(plan), _plan(starved)]


# ---- policy: admission --------------------------------------------------


def case_admission_deadline_ordered_then_fifo(m):
    q = m.queue.SchedQueue()
    _add(m, q, "late", 4, deadline=100.0)
    _add(m, q, "urgent", 4, deadline=5.0)
    _add(m, q, "none1", 4)
    _add(m, q, "none2", 4)
    plan = m.policy.SchedulerPolicy(64, 16).plan(q, FakeEngine(slots=8))
    assert plan.admitted == ["urgent", "late", "none1", "none2"]
    return [_plan(plan), _states(q)]


def case_admission_respects_slot_pool(m):
    q = m.queue.SchedQueue()
    for i in range(3):
        _add(m, q, f"w{i}", 4)
    _add(m, q, "run", 4, step=2).state = m.kinds.STATE_DECODING
    plan = m.policy.SchedulerPolicy(64, 16).plan(q, FakeEngine(slots=2))
    assert plan.admitted == ["w0"]
    return [_plan(plan), _states(q)]


def case_admission_gated_by_free_blocks_with_failfast(m):
    q = m.queue.SchedQueue()
    _add(m, q, "w0", 64)  # 9 blocks of 8 with its decode token
    _add(m, q, "run", 4, step=1).state = m.kinds.STATE_DECODING
    starved = FakeEngine(slots=4, free_blocks=2)
    plan = m.policy.SchedulerPolicy(256, 256).plan(q, starved)
    assert plan.admitted == [] and q.get("w0").state == m.kinds.STATE_WAITING
    q.remove("run")
    plan2 = m.policy.SchedulerPolicy(256, 256).plan(q, starved)
    assert plan2.admitted == ["w0"]  # nothing running: admitted to fail fast
    return [_plan(plan), _plan(plan2), _states(q)]


def case_preempted_request_waits_for_its_driver_step(m):
    q = m.queue.SchedQueue()
    r = _add(m, q, "pre", 8, step=4)
    r.state = m.kinds.STATE_DECODING
    q.requeue("pre", reason_preempt=True)
    r.pending_step = None
    policy, eng = m.policy.SchedulerPolicy(64, 16), FakeEngine()
    assert not policy.has_work(q, eng)
    first = policy.plan(q, eng)
    assert first.admitted == []
    r.pending_step = 5
    assert policy.has_work(q, eng)
    second = policy.plan(q, eng)
    assert second.admitted == ["pre"]
    return [_plan(first), _plan(second), _states(q)]


# ---- queue --------------------------------------------------------------


def case_victims_least_urgent_first(m):
    q = m.queue.SchedQueue()
    for nonce, dl in (("a", 5.0), ("b", None), ("c", 50.0)):
        _add(m, q, nonce, 4, deadline=dl, step=1).state = m.kinds.STATE_DECODING
    assert q.victims() == ["b", "c", "a"]
    return [q.victims()]


def case_requeue_preserves_arrival_priority(m):
    q = m.queue.SchedQueue()
    _add(m, q, "first", 4, step=2).state = m.kinds.STATE_DECODING
    _add(m, q, "second", 4)
    q.requeue("first", reason_preempt=True)
    first = q.get("first")
    assert first.state == m.kinds.STATE_WAITING and first.preemptions == 1 and first.prefilled == 0
    assert [r.nonce for r in q.waiting()] == ["first", "second"]
    q.requeue("second", reason_preempt=False)
    assert q.get("second").starved == 1 and q.active() == 0
    return [_states(q), [r.nonce for r in q.waiting()]]


# ---- step execution -----------------------------------------------------


def _chunk(m, nonce, n_ids=8, victims=(), last=True):
    return m.policy.PrefillChunk(
        nonce=nonce, ids=list(range(n_ids)), start=0, end=n_ids, first=True, last=last,
        decoding=m.types.DecodingParams(), pending_step=0, seed=None, victims=list(victims),
    )


def case_prefill_starvation_evicts_lower_priority_victim(m):
    eng = FakeStepEngine(m, fail_prefill={"urgent"})
    eng.occupy("low", committed=6, blocks=2)
    plan = m.policy.TickPlan()
    plan.decode = {"low": (42, m.types.DecodingParams())}
    plan.steps, plan.ids, plan.victims = {"low": 3}, {"low": list(range(8))}, ["low"]
    plan.prefills = [_chunk(m, "urgent", victims=["low"])]
    res = m.step.execute_tick(eng, plan)
    assert "low" in res.decode_results and res.preempted == ["low"]
    assert eng.ended == ["low"] and eng.stored == ["low"]
    assert res.progress["urgent"] == 0 and "urgent" not in res.errors
    return [_result(res), eng.ended, eng.stored]


def case_prefill_starvation_without_victim_requeues(m):
    eng = FakeStepEngine(m, fail_prefill={"u"})
    eng.occupy("other", committed=6, blocks=2)
    plan = m.policy.TickPlan()
    plan.prefills = [_chunk(m, "u")]
    res = m.step.execute_tick(eng, plan)
    assert res.requeued == ["u"] and "u" not in eng.slot_of and eng.ended == []
    return [_result(res), sorted(eng.slot_of)]


def case_prefill_starvation_alone_is_typed_error(m):
    eng = FakeStepEngine(m, fail_prefill={"u"})
    plan = m.policy.TickPlan()
    plan.prefills = [_chunk(m, "u")]
    res = m.step.execute_tick(eng, plan)
    assert "exhausted" in res.errors["u"] and res.requeued == []
    return [_result(res)]


def case_decode_starvation_evicts_least_urgent_lane(m):
    eng = FakeStepEngine(m, pool_free=0)
    eng.occupy("high", committed=8, blocks=1)  # the next token needs a second block
    eng.occupy("low", committed=8, blocks=1)
    plan = m.policy.TickPlan()
    plan.decode = {"high": (1, m.types.DecodingParams()), "low": (2, m.types.DecodingParams())}
    plan.steps = {"high": 5, "low": 5}
    plan.ids = {"high": list(range(8)), "low": list(range(8))}
    plan.victims = ["low", "high"]
    res = m.step.execute_tick(eng, plan)
    assert res.preempted == ["low"] and "high" in res.decode_results and "low" not in res.decode_results
    return [_result(res), eng.ended]


def case_chunked_prefill_then_adopt(m):
    """A prompt in two segments: the first stages, the last stores the
    prefix and adopts with its sample; decode lanes step first."""
    eng = FakeStepEngine(m)
    eng.occupy("d", committed=8, blocks=1)
    plan = m.policy.TickPlan()
    plan.decode, plan.steps = {"d": (3, m.types.DecodingParams())}, {"d": 1}
    plan.prefills = [_chunk(m, "p", n_ids=8, last=False)]
    first = m.step.execute_tick(eng, plan)
    eng.eng.sessions["p"] = SimpleNamespace(pos=first.progress["p"])
    plan2 = m.policy.TickPlan()
    last = _chunk(m, "p", n_ids=12)
    last.first = False
    plan2.prefills = [last]
    second = m.step.execute_tick(eng, plan2)
    assert first.decode_results == {"d": "tok-d"} and first.progress == {"p": 8}
    assert second.adopted == {"p": "sample-p"} and second.prefill_tokens == 4 and eng.stored == ["p"]
    return [_result(first), _result(second)]


def case_starved_requeue_is_bounded_by_typed_error(m):
    adapter = m.engine.SchedulerAdapter(FakeStepEngine(m))
    req = adapter.queue.add("n", [1, 2, 3], m.types.DecodingParams())
    req.pending_step = 0
    plan = m.policy.TickPlan()
    limit = m.step.MAX_STARVED_REQUEUES
    for _ in range(limit - 1):
        adapter._apply(plan, m.step.TickResult(requeued=["n"]))
        assert adapter.queue.get("n").state == m.kinds.STATE_WAITING
    assert adapter.queue.get("n").starved == limit - 1
    adapter._apply(plan, m.step.TickResult(requeued=["n"]))
    assert adapter.queue.get("n") is None  # errored out, not requeued
    return [limit]


CASES = {name[5:]: fn for name, fn in list(globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pkg", PACKAGES)
def test_case(pkg, case):
    CASES[case](_modules(pkg))


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_equal_across_packages(case):
    ref, port = (CASES[case](_modules(pkg)) for pkg in PACKAGES)
    assert port == ref


def test_port_counts_queue_depths_and_preemptions():
    """The reference's queue-depth gauges and preemption counter are plain
    counts in the port."""
    m = _modules("dnet_tpu_torch")
    q = m.queue.SchedQueue()
    r = _add(m, q, "x", 4)
    assert q.depths == {"waiting": 1, "prefilling": 0, "decoding": 0}
    r.state = m.kinds.STATE_DECODING
    q.sync_gauges()
    assert q.depths["decoding"] == 1
    q.remove("x")
    assert q.depths == {"waiting": 0, "prefilling": 0, "decoding": 0}
    before = m.step.PREEMPTIONS["block_starvation"]
    case_prefill_starvation_evicts_lower_priority_victim(m)
    assert m.step.PREEMPTIONS["block_starvation"] == before + 1
