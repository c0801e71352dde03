"""Unified observability: metrics registry + per-request flight recorder.

Counterpart of dnet_tpu/obs/__init__.py: the same canonical family set,
with the reference's names, types, HELP strings and label sets, so that a
harness that reads the reference's exposition reads the port's unchanged.
Two differences: `dnet_jit_compiles_total{fn}` counts the builds of the
CUDA sources (obs/phases.py KERNEL_SOURCES; the port has no jax.jit), and
the families of subsystems not ported yet (the runtime sanitizer, the
fleet, tensor parallelism) are exposed at zero, as on a reference node that
never uses them.

One process-global `MetricsRegistry` (Prometheus text exposition at
`GET /metrics` on both the API and shard HTTP servers) and one
`FlightRecorder` (span timelines at `GET /v1/debug/timeline/{rid}`).
Instrumented modules fetch family handles by name via `metric()`; the
canonical family set below is registered on first access so `/metrics`
exposes every series — zero-valued — from process start, and so a typo'd
name fails loudly at import instead of silently creating a parallel series.

`obs_enabled()` is the ONE truth for profile gating: the `[PROFILE]` log
filter (utils/logger.py) and any sampling decisions both consult it, so the
legacy `DNET_PROFILE` env and `DNET_OBS_ENABLED` (config.ObsSettings) can
never disagree.  The registry and recorder themselves are always on —
counters are near-free and the recorder is bounded — gating covers only the
log-line firehose and the device-sync fences.
"""

from __future__ import annotations

import threading

from dnet_tpu_torch.obs.metrics import (
    CONTENT_TYPE_LATEST,
    DEFAULT_MS_BUCKETS,
    METRIC_NAME_RE,
    MetricFamily,
    MetricsRegistry,
)
from dnet_tpu_torch.obs.recorder import FlightRecorder

__all__ = [
    "CONTENT_TYPE_LATEST",
    "DEFAULT_MS_BUCKETS",
    "METRIC_NAME_RE",
    "FlightRecorder",
    "MetricFamily",
    "MetricsRegistry",
    "get_recorder",
    "get_registry",
    "get_slo_tracker",
    "metric",
    "obs_enabled",
    "reset_obs",
]

_registry = MetricsRegistry()
_recorder = FlightRecorder()
_core_once = threading.Lock()
_core_done = False

# lane-depth / small-count histograms use power-of-two buckets, not ms
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)

_CACHE_KINDS = ("prefix", "snapshot")


def _register_core(reg: MetricsRegistry) -> None:
    """The canonical family set, pre-registered (and labeled children
    pre-touched) so exposition carries them at zero before first use."""
    reg.histogram(
        "dnet_decode_step_ms",
        "Per-token decode step wall time on the serving path (ms)",
    )
    reg.histogram(
        "dnet_prefill_ms", "Prompt prefill wall time per request (ms)"
    )
    reg.histogram(
        "dnet_ttft_ms", "Time to first token per request (ms)"
    )
    reg.histogram(
        "dnet_layer_compute_ms",
        "Per-layer compute wall time under DNET_OBS_SYNC_PER_LAYER (ms)",
    )
    reg.histogram(
        "dnet_token_rpc_ms",
        "Shard-to-API token callback RPC latency (ms)",
    )
    reg.histogram(
        "dnet_ring_hop_rtt_ms",
        "API-observed token frame send-to-resolve round trip (ms)",
    )
    reg.histogram(
        "dnet_lane_queue_wait_ms",
        "Decode-step wait in the lane coalescing queue (ms)",
    )
    reg.histogram(
        "dnet_lane_flush_depth",
        "Members per flushed multi-lane ring frame",
        buckets=COUNT_BUCKETS,
    )
    reg.counter(
        "dnet_transport_tx_bytes_total",
        "Activation/token frame payload bytes written to outbound streams",
    )
    reg.counter(
        "dnet_transport_rx_bytes_total",
        "Activation/token frame payload bytes admitted at ingress",
    )
    reg.counter(
        "dnet_transport_tx_frames_total",
        "Frames written to outbound streams",
    )
    reg.counter(
        "dnet_transport_backpressure_total",
        "Backpressure ACKs that paused an outbound stream",
    )
    for name, help_text in (
        ("dnet_kv_cache_hits_total", "KV snapshot cache hits"),
        ("dnet_kv_cache_misses_total", "KV snapshot cache misses"),
        ("dnet_kv_cache_evictions_total", "KV snapshot cache LRU evictions"),
        ("dnet_kv_cache_stores_total", "KV snapshots stored"),
    ):
        fam = reg.counter(name, help_text, labelnames=("cache",))
        for kind in _CACHE_KINDS:
            fam.labels(cache=kind)  # pre-touch: expose at 0 from the start
    reg.counter(
        "dnet_kv_sessions_evicted_total",
        "Per-nonce KV sessions dropped by the TTL sweep",
    )
    # paged KV pool (kv/paged.py): used + free == pool size at all
    # times (shared blocks count once in used; BlockPool.check_conservation)
    reg.gauge(
        "dnet_kv_blocks_used",
        "Paged KV pool blocks currently allocated (refcount >= 1)",
    )
    reg.gauge(
        "dnet_kv_blocks_free",
        "Paged KV pool blocks on the free list",
    )
    reg.gauge(
        "dnet_kv_pool_blocks",
        "Paged KV pool total capacity in blocks",
    )
    reg.counter(
        "dnet_kv_cow_copies_total",
        "Paged KV copy-on-write block copies (shared block diverged)",
    )
    reg.counter(
        "dnet_kv_prefix_shared_blocks_total",
        "Paged KV blocks shared by refcount aliasing instead of copying",
    )
    reg.counter(
        "dnet_kv_admission_rejected_total",
        "Paged KV admissions/extensions refused for lack of free blocks",
    )
    reg.counter("dnet_requests_total", "Decode requests started")
    reg.counter(
        "dnet_request_errors_total", "Decode requests failed with an error"
    )
    reg.counter(
        "dnet_tokens_generated_total", "Tokens emitted across all requests"
    )
    reg.counter(
        "dnet_prefix_refill_total",
        "Ring prefix-cache misses transparently re-sent as full prefills",
    )
    # resilience (resilience/): retries, stream re-open, resume, and the
    # chaos harness that exercises all of them
    retries = reg.counter(
        "dnet_rpc_retries_total",
        "RPC attempts retried under the resilience backoff policy",
        labelnames=("method",),
    )
    for m in ("send_activation", "send_token", "reset_cache",
              "measure_latency", "load_model"):
        retries.labels(method=m)  # pre-touch: expose at 0 from the start
    reg.counter(
        "dnet_stream_reopens_total",
        "Broken activation streams re-opened with the in-flight frame "
        "re-sent",
    )
    reg.counter(
        "dnet_request_resumed_total",
        "Requests transparently resumed after a mid-decode failure",
    )
    reg.counter(
        "dnet_resume_replay_tokens_total",
        "Tokens (prompt + generated) replayed by request-resume prefills",
    )
    # admission / overload survival (admission/): bounded queue,
    # load shedding, end-to-end deadlines, drain.  Reason/stage label sets
    # are DECLARED in admission/reasons.py.
    reg.gauge(
        "dnet_admit_queue_depth",
        "Requests currently waiting in the bounded admission queue",
    )
    reg.gauge(
        "dnet_admit_inflight",
        "Requests currently holding an admission slot (executing)",
    )
    reg.counter(
        "dnet_admit_admitted_total",
        "Requests granted an admission slot",
    )
    reg.histogram(
        "dnet_admit_wait_ms",
        "Admission-queue wait before a slot was granted (ms)",
    )
    from dnet_tpu_torch.admission.reasons import DEADLINE_STAGES, REJECT_REASONS
    from dnet_tpu_torch.membership.epoch import RECOVERY_OUTCOMES, STALE_EPOCH_KINDS
    from dnet_tpu_torch.obs.phases import (
        REPLICA_STATES,
        ROUTE_REASONS,
        RUNTIME_CHECK_CODES,
        ZOMBIE_THREAD_KINDS,
    )
    from dnet_tpu_torch.resilience.chaos import INJECTION_POINTS

    rejected = reg.counter(
        "dnet_admit_rejected_total",
        "Requests shed at admission (reason per admission/reasons.py)",
        labelnames=("reason",),
    )
    for reason in REJECT_REASONS:
        rejected.labels(reason=reason)  # pre-touch: exposed at 0 from the start
    exceeded = reg.counter(
        "dnet_deadline_exceeded_total",
        "End-to-end request deadlines found expired, by pipeline stage",
        labelnames=("stage",),
    )
    for stage in DEADLINE_STAGES:
        exceeded.labels(stage=stage)  # pre-touch: exposed at 0 from the start
    reg.counter(
        "dnet_cancel_propagated_total",
        "Client disconnects fanned out as cancel + reset_cache to the ring",
    )
    reg.gauge(
        "dnet_drain_state",
        "1 while the server is draining for shutdown (503 for new work)",
    )
    reg.counter(
        "dnet_shard_outq_dropped_total",
        "Shard output-queue frames dropped on overflow (error surfaced "
        "upstream in their place)",
    )
    # elastic ring membership (membership/, api/failure.py): epoch fence +
    # recovery/rejoin accounting.  Kind/outcome label sets are DECLARED in
    # membership/epoch.py (a leaf module, like admission/reasons.py).
    reg.gauge(
        "dnet_topology_epoch",
        "Ring topology epoch this process holds (API: minted; shard: "
        "pinned at load; 0 = unfenced)",
    )
    stale = reg.counter(
        "dnet_stale_epoch_rejected_total",
        "Messages fenced out for carrying a dead topology epoch "
        "(kind per membership/epoch.py)",
        labelnames=("kind",),
    )
    for kind in STALE_EPOCH_KINDS:
        stale.labels(kind=kind)  # pre-touch: exposed at 0 from the start
    recovery = reg.counter(
        "dnet_recovery_total",
        "Ring recovery/rejoin rounds by outcome (membership/epoch.py)",
        labelnames=("outcome",),
    )
    for outcome in RECOVERY_OUTCOMES:
        recovery.labels(outcome=outcome)  # pre-touch: exposed at 0 from the start
    reg.histogram(
        "dnet_recovery_duration_seconds",
        "Wall time of one recovery/rejoin round (re-solve + reload)",
        buckets=(0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
    )
    reg.counter(
        "dnet_shard_rejoins_total",
        "Quarantined shards re-admitted to the ring without operator action",
    )
    chaos_fam = reg.counter(
        "dnet_chaos_injected_total",
        "Faults injected by the deterministic chaos harness",
        labelnames=("point",),
    )
    for point in INJECTION_POINTS:
        chaos_fam.labels(point=point)  # pre-touch: exposed at 0 from the start
    # labeled "peer", NOT "node": federation injects node="api" into every
    # API-section sample, and a node label here would collide with it
    reg.gauge(
        "dnet_federation_scrape_ok",
        "1 if the last /v1/cluster/metrics scrape of this peer succeeded",
        labelnames=("peer",),
    )
    reg.gauge(
        "dnet_slo_ttft_p95_ms",
        "Rolling-window TTFT p95 against the SLO target (ms)",
    )
    reg.gauge(
        "dnet_slo_decode_p95_ms",
        "Rolling-window decode-step p95 against the SLO target (ms)",
    )
    # p99 twins for load-report cross-validation (attainment logic stays
    # p95-based; these exist so loadgen tail percentiles have a live peer)
    reg.gauge(
        "dnet_slo_ttft_p99_ms",
        "Rolling-window TTFT p99 (informational; attainment is p95-based)",
    )
    reg.gauge(
        "dnet_slo_decode_p99_ms",
        "Rolling-window decode-step p99 (informational; attainment is "
        "p95-based)",
    )
    reg.gauge(
        "dnet_slo_availability",
        "Rolling-window request availability (1 - errors/requests)",
    )
    burning = reg.gauge(
        "dnet_slo_burning",
        "1 when the named SLO is violating its target over the window",
        labelnames=("slo",),
    )
    from dnet_tpu_torch.obs.slo import SLO_KINDS

    for kind in SLO_KINDS:
        burning.labels(slo=kind)  # pre-touch: expose at 0 from the start
    # performance attribution (obs/phases.py, obs/jit.py): decode-step
    # sub-phase breakdown, jit compile tracking, device memory.  Phase /
    # fn / kind label sets are DECLARED in obs/phases.py (a leaf module)
    #.
    from dnet_tpu_torch.obs.phases import DEVICE_MEM_KINDS, KERNEL_SOURCES, STEP_PHASES

    phase_fam = reg.histogram(
        "dnet_step_phase_ms",
        "Batched decode-step sub-phase wall time (obs/phases.py; fenced "
        "timings recorded when obs_enabled())",
        labelnames=("phase",),
    )
    for phase in STEP_PHASES:
        phase_fam.labels(phase=phase)  # pre-touch: exposed at 0 from the start
    compiles = reg.counter(
        "dnet_jit_compiles_total",
        "Traced+compiled calls per instrumented jit entry point "
        "(obs/phases.py JIT_FNS)",
        labelnames=("fn",),
    )
    for fn in KERNEL_SOURCES:
        compiles.labels(fn=fn)  # pre-touch: exposed at 0 from the start
    reg.histogram(
        "dnet_jit_compile_ms",
        "Wall time of calls that compiled (trace + compile + first run)",
        buckets=(10.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                 10000.0, 30000.0, 60000.0),
    )
    mem = reg.gauge(
        "dnet_device_mem_bytes",
        "Backend device memory summed over local devices, where the PJRT "
        "backend reports stats (0 on CPU)",
        labelnames=("kind",),
    )
    for kind in DEVICE_MEM_KINDS:
        mem.labels(kind=kind)  # pre-touch: expose at 0 from the start
    # overlapped wire pipeline (transport/wire_pipeline.py,
    # DNET_WIRE_PIPELINE=1).  The dir label set is DECLARED in
    # obs/phases.py (leaf).
    from dnet_tpu_torch.obs.phases import WIRE_DIRS

    reg.histogram(
        "dnet_wire_encode_ms",
        "Hop-codec encode wall time per frame (D2H readback + byte "
        "packing; tx-stage time under the wire pipeline, compute-thread "
        "time without it)",
    )
    reg.histogram(
        "dnet_wire_decode_ms",
        "Hop-codec decode wall time per frame (H2D upload + on-device "
        "dequant dispatch; ingress time under the wire pipeline, "
        "compute-thread time without it)",
    )
    wire_bytes = reg.counter(
        "dnet_wire_bytes_total",
        "Activation/token frame payload bytes by wire direction "
        "(obs/phases.py WIRE_DIRS)",
        labelnames=("dir",),
    )
    for d in WIRE_DIRS:
        wire_bytes.labels(dir=d)  # pre-touch: exposed at 0 from the start
    reg.gauge(
        "dnet_wire_overlap_ratio",
        "Fraction of cumulative hop-codec time hidden off the compute "
        "thread (1.0 = codec fully overlapped with compute)",
    )
    # intra-shard tensor parallelism (parallel/tp.py, DNET_TP=N).  The op
    # label set is DECLARED in obs/phases.py TP_OPS (leaf) and
    #.
    from dnet_tpu_torch.obs.phases import TP_OPS

    tp_ms = reg.histogram(
        "dnet_tp_collective_ms",
        "Intra-shard TP collective latency from the load-time calibration "
        "probe (per-op timing cannot be carved out of the fused layer "
        "programs at serving time)",
        labelnames=("op",),
    )
    tp_bytes = reg.counter(
        "dnet_tp_collective_bytes_total",
        "Analytic interconnect bytes dispatched per TP collective "
        "(ring-algorithm accounting, parallel/tp_collectives.py)",
        labelnames=("op",),
    )
    for op in TP_OPS:
        tp_ms.labels(op=op)  # pre-touch: exposed at 0 from the start
        tp_bytes.labels(op=op)  # pre-touch: exposed at 0 from the start
    reg.gauge(
        "dnet_tp_degree",
        "Resolved tensor-parallel degree of this process's serving engine "
        "(1 = single-chip, the pre-TP behavior)",
    )
    # runtime concurrency sanitizer (the reference's, not ported: at zero).
    # Check-code / thread label sets are DECLARED in
    # analysis/runtime/domains.py (a leaf module).
    san_findings = reg.counter(
        "dnet_san_findings_total",
        "Runtime sanitizer (dsan) findings recorded, by DS check code",
        labelnames=("check",),
    )
    for code in RUNTIME_CHECK_CODES:
        san_findings.labels(check=code)  # pre-touch: exposed at 0 from the start
    zombies = reg.counter(
        "dnet_san_zombie_threads_total",
        "Worker threads that failed to join at stop() and were leaked as "
        "daemons (a wedged worker must be visible, not silent)",
        labelnames=("thread",),
    )
    for kind in ZOMBIE_THREAD_KINDS:
        zombies.labels(thread=kind)  # pre-touch: exposed at 0 from the start
    # iteration-level scheduler (sched/, DNET_SCHED=1).  State /
    # kind / reason label sets are DECLARED in sched/kinds.py (a leaf
    # module, like admission/reasons.py).
    from dnet_tpu_torch.sched.kinds import BATCH_KINDS, PREEMPT_REASONS, QUEUE_STATES

    reg.histogram(
        "dnet_sched_tick_ms",
        "One scheduler tick wall time: the mixed prefill+decode plan "
        "executed on the compute thread",
    )
    batch_fam = reg.histogram(
        "dnet_sched_batch_tokens",
        "Per-tick batch composition: prompt tokens chunk-prefilled and "
        "decode lanes stepped in the same tick (sched/kinds.py)",
        labelnames=("kind",),
        buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                 512.0, 1024.0, 2048.0),
    )
    for kind in BATCH_KINDS:
        batch_fam.labels(kind=kind)  # pre-touch: exposed at 0 from the start
    preempt = reg.counter(
        "dnet_sched_preemptions_total",
        "Sequences evicted back to WAITING by the scheduler "
        "(reason per sched/kinds.py)",
        labelnames=("reason",),
    )
    for reason in PREEMPT_REASONS:
        preempt.labels(reason=reason)  # pre-touch: exposed at 0 from the start
    depth = reg.gauge(
        "dnet_sched_queue_depth",
        "Requests resident in the scheduler queue, by live state "
        "(sched/kinds.py)",
        labelnames=("state",),
    )
    for state in QUEUE_STATES:
        depth.labels(state=state)  # pre-touch: exposed at 0 from the start
    # critical-path attribution (obs/critical_path.py): the exhaustive
    # per-request segment ledger.  The segment label set is DECLARED in
    # obs/phases.py REQUEST_SEGMENTS (leaf).
    from dnet_tpu_torch.obs.phases import REQUEST_SEGMENTS

    seg_fam = reg.histogram(
        "dnet_request_segment_ms",
        "Per-request critical-path segment ledger: exhaustive, "
        "non-overlapping wall-time attribution of one request's recorded "
        "spans (obs/phases.py REQUEST_SEGMENTS; obs/critical_path.py)",
        labelnames=("segment",),
    )
    for seg in REQUEST_SEGMENTS:
        seg_fam.labels(segment=seg)  # pre-touch: exposed at 0 from the start
    # scheduler tick flight-recorder (sched/flight.py): the bounded
    # TickRecord ring behind GET /v1/debug/sched
    reg.counter(
        "dnet_sched_tick_records_total",
        "Scheduler ticks captured into the tick flight-recorder ring "
        "(sched/flight.py; bounded by DNET_OBS_TICK_RECORDS)",
    )
    # structured wide events (obs/events.py): the canonical event journal
    # behind GET /v1/debug/events.  The name vocabulary is DECLARED in
    # obs/phases.py EVENT_NAMES (leaf).
    from dnet_tpu_torch.obs.phases import EVENT_NAMES

    events_fam = reg.counter(
        "dnet_events_total",
        "Structured wide events journaled by log_event "
        "(obs/phases.py EVENT_NAMES; obs/events.py)",
        labelnames=("name",),
    )
    for event_name in EVENT_NAMES:
        events_fam.labels(name=event_name)  # pre-touch: exposed at 0 from the start
    reg.histogram(
        "dnet_sched_tick_budget_used_ratio",
        "Fraction of the per-tick token budget the planned batch consumed "
        "(1.0 = saturated tick; sched/flight.py)",
        buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
    )
    # fleet routing (the reference's, not ported: at zero): replica-state and
    # routing-reason label sets are DECLARED in fleet/states.py (leaf) and
    #.  The
    # `replica` label is operator-assigned (r0, r1, ...) — dynamic, so no
    # pre-touch loop; the enum-valued families below get one.
    reg.counter(
        "dnet_fleet_requests_total",
        "Requests the fleet front door dispatched, by serving replica "
        "(fleet/manager.py; replica ids are deployment-assigned)",
        labelnames=("replica",),
    )
    routed_fam = reg.counter(
        "dnet_fleet_routed_total",
        "Routing decisions by policy reason "
        "(fleet/states.py ROUTE_REASONS; fleet/router.py)",
        labelnames=("reason",),
    )
    for reason in ROUTE_REASONS:
        routed_fam.labels(reason=reason)  # pre-touch: exposed at 0 from the start
    reg.counter(
        "dnet_fleet_affinity_hits_total",
        "Requests routed by a sticky prefix-affinity entry to the replica "
        "holding their COW prefix blocks (fleet/router.py)",
    )
    reg.counter(
        "dnet_fleet_failovers_total",
        "In-flight requests migrated off a dead replica to a survivor "
        "via deterministic replay (fleet/manager.py)",
    )
    replicas_fam = reg.gauge(
        "dnet_fleet_replicas",
        "Fleet replicas by lifecycle state "
        "(fleet/states.py REPLICA_STATES; fleet/manager.py)",
        labelnames=("state",),
    )
    for state in REPLICA_STATES:
        replicas_fam.labels(state=state)  # pre-touch: exposed at 0 from the start


def _ensure_core() -> None:
    global _core_done
    if _core_done:
        return
    with _core_once:
        if not _core_done:
            _register_core(_registry)
            _core_done = True


def get_registry() -> MetricsRegistry:
    """The process-global registry (core families registered)."""
    _ensure_core()
    return _registry


def get_recorder() -> FlightRecorder:
    return _recorder


_slo_tracker = None
_slo_lock = threading.Lock()


def get_slo_tracker():
    """The process-global SLO tracker, built from ObsSettings targets on
    first access (lazy so tests can mutate the env, reset the settings
    cache, and reset_obs() to pick the new targets up)."""
    global _slo_tracker
    if _slo_tracker is None:
        with _slo_lock:
            if _slo_tracker is None:
                from dnet_tpu_torch.config import obs_settings
                from dnet_tpu_torch.obs.slo import SloTracker

                obs = obs_settings()
                _slo_tracker = SloTracker(
                    window_s=obs.slo_window_s,
                    ttft_p95_ms=obs.slo_ttft_p95_ms,
                    decode_p95_ms=obs.slo_decode_p95_ms,
                    availability=obs.slo_availability,
                )
    return _slo_tracker


def metric(name: str) -> MetricFamily:
    """Fetch a registered family by name; unknown names raise (catching
    typos at import time beats a silently separate series)."""
    _ensure_core()
    fam = _registry.get(name)
    if fam is None:
        raise KeyError(f"metric {name!r} is not registered; add it to "
                       f"dnet_tpu_torch.obs._register_core")
    return fam


def obs_enabled() -> bool:
    """Single profile-gating truth: DNET_OBS_ENABLED (ObsSettings) or the
    legacy DNET_PROFILE env, whichever is set (both read from the process
    environment on every call, two lookups: the served path asks once a
    step)."""
    from dnet_tpu_torch.config import env_flag

    return env_flag("DNET_OBS_ENABLED") or env_flag("DNET_PROFILE")


def reset_obs() -> None:
    """Zero metrics in place and drop recorded timelines (for tests).
    Family/child objects survive, so handles held by instrumented modules
    stay valid.  The SLO tracker is DROPPED, not zeroed — the next
    get_slo_tracker() re-reads targets from settings, so a test that
    changed DNET_OBS_SLO_* (and reset the settings cache) sees them."""
    global _slo_tracker
    _ensure_core()
    _registry.reset()
    _recorder.clear()
    # the scheduler tick ring is obs state too (captured under
    # obs_enabled, dumped by /v1/debug/sched): a test that resets the
    # books must not inherit a previous run's ticks.  Imported here, not
    # at module top: sched.flight itself imports dnet_tpu_torch.obs.
    from dnet_tpu_torch.sched.flight import get_tick_recorder

    get_tick_recorder().clear()
    # the wide-event journal is obs state too: drop ring + sink so the
    # next log_event re-reads DNET_OBS_EVENTS_* from fresh settings.
    # Late import: obs.events imports dnet_tpu_torch.obs for metric().
    from dnet_tpu_torch.obs.events import reset_events

    reset_events()
    with _slo_lock:
        _slo_tracker = None
