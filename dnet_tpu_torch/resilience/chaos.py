"""Deterministic, seeded fault injection for the recovery paths.

Counterpart of dnet_tpu/resilience/chaos.py, the same grammar, points and
schedule: for one spec and seed, the port fires on exactly the calls the
reference fires on.

Every retry/resume path this subsystem ships is exercised by reproducible
tests rather than by killing processes and hoping: named injection points
are wired into the transport send (``send_activation``), the shard->API
token callback (``token_cb``), the failure monitor's probe
(``health_check``), the shard compute thread (``shard_compute``), the
admission controller (``admit`` — a delay here reproduces overload
deterministically), and a
spec string — ``DNET_CHAOS="shard_compute:error_at:5,
send_activation:error:0.1,token_cb:delay:50ms"`` — schedules faults at
them.  The schedule is a pure function of the seed and each point's call
counter (one seeded RNG per point, counters advance only at that point's
call sites), so two runs of the same workload inject the identical fault
sequence; there is no wall-clock or cross-point coupling.

Spec grammar (comma-separated, one spec per point; later wins):

- ``point:error:P``    — raise `ChaosError` with probability P per call
- ``point:error_at:N`` — raise on exactly the Nth call (1-based;
  ``N+M+...`` lists several)
- ``point:delay:D``    — sleep D per call (``50ms``, ``0.5s``, or seconds)
- ``point:partition:S+W`` — a seeded outage window: calls S..S+W-1
  (1-based) all raise, then the point heals and every later call passes.
  Partitioning BOTH directions of a hop (``send_activation`` forward and
  ``token_cb`` return) over the same window reproduces a network
  partition of that link deterministically — recovery, delta
  reconfiguration and resume all run against the healed ring.

`ChaosError` subclasses `ConnectionError` so the retry policy's
classification (resilience/policy.py) treats an injected fault exactly like
a real transport failure.  Injections count into
``dnet_chaos_injected_total{point=}``.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

# The declared injection-point names; the metrics registry pre-touches a
# dnet_chaos_injected_total{point=} series for each (obs/__init__.py), so
# a new point cannot ship without its observability.  wire_encode /
# wire_decode fire at the shard's synchronous hop encode and decode seams
# (the overlapped wire pipeline is not ported); fleet_dispatch has no
# call site in the port (no fleet) and stays at zero.
INJECTION_POINTS: Tuple[str, ...] = (
    "send_activation",  # StreamManager.send, before the stream write
    "token_cb",         # shard -> API token callback (RingAdapter._cb_send)
    "health_check",     # RingFailureMonitor's per-shard probe
    "shard_compute",    # ShardRuntime compute thread, before process()
    "admit",            # AdmissionController.acquire, before any check —
                        # a delay here backs the bounded queue up exactly
                        # like a slow burst (deterministic overload tests)
    "zombie_frame",     # shard ingress epoch fence (RingAdapter): an
                        # injected error marks the frame STALE, simulating
                        # a zombie sender without racing a real partition
    "rejoin",           # failure monitor's rejoin attempt: an injected
                        # error aborts the attempt (the shard re-earns its
                        # stability window), exercising rejoin retry
    "wire_encode",      # hop-codec encode (PendingWirePayload.finalize /
                        # the synchronous encode seam): a delay here wedges
                        # the tx stage deterministically — the encode ring
                        # fills and compute blocks on backpressure
    "wire_decode",      # hop-codec decode: an error fails the frame's
                        # decode exactly like a corrupt payload would.
                        # Fires ASYNC at ingress before predecode (a delay
                        # parks that frame's admission, not the loop) and
                        # sync on the compute thread's fallback decode
    "fleet_dispatch",   # FleetManager's per-candidate dispatch (both the
                        # streaming _acquire walk and the non-streaming
                        # generate walk): an injected error fails that
                        # candidate exactly like a dead replica — the walk
                        # falls through to the next; all faulted => the
                        # fleet sheds (429), never a 500
    "update_topology",  # shard delta-reconfig entry (Shard.update_topology
                        # and the in-process membership harness): an error
                        # fails the delta exactly like an unreachable
                        # shard — the API's retry/full-load fallback runs
)

KINDS: Tuple[str, ...] = ("error", "error_at", "delay", "partition")
_KINDS = KINDS  # back-compat alias


class ChaosError(ConnectionError):
    """An injected fault.  ConnectionError base => retryable by the policy
    classifier, same as a real broken channel."""


def _parse_duration(raw: str) -> float:
    raw = raw.strip().lower()
    if raw.endswith("ms"):
        return float(raw[:-2]) / 1000.0
    if raw.endswith("s"):
        return float(raw[:-1])
    return float(raw)


@dataclass
class _PointSpec:
    kind: str
    prob: float = 0.0
    delay_s: float = 0.0
    at: Tuple[int, ...] = ()
    # partition window: calls part_start..part_start+part_width-1 raise
    part_start: int = 0
    part_width: int = 0


@dataclass
class ChaosInjector:
    """Parsed spec + per-point counters/RNGs.  Thread-safe: shard_compute
    fires from the compute thread while transport points fire on the event
    loop."""

    spec: str
    seed: int = 0
    points: Dict[str, _PointSpec] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.points = self._parse(self.spec)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {p: 0 for p in self.points}
        self._rngs: Dict[str, random.Random] = {
            p: random.Random(f"{self.seed}:{p}") for p in self.points
        }

    @staticmethod
    def _parse(spec: str) -> Dict[str, _PointSpec]:
        out: Dict[str, _PointSpec] = {}
        for part in (p.strip() for p in spec.split(",") if p.strip()):
            fields = part.split(":")
            if len(fields) != 3:
                raise ValueError(
                    f"chaos spec {part!r} must be point:kind:param"
                )
            point, kind, param = (f.strip() for f in fields)
            if point not in INJECTION_POINTS:
                raise ValueError(
                    f"unknown chaos point {point!r}; declared points: "
                    f"{', '.join(INJECTION_POINTS)}"
                )
            if kind == "error":
                out[point] = _PointSpec(kind, prob=float(param))
            elif kind == "error_at":
                out[point] = _PointSpec(
                    kind, at=tuple(int(n) for n in param.split("+"))
                )
            elif kind == "delay":
                out[point] = _PointSpec(kind, delay_s=_parse_duration(param))
            elif kind == "partition":
                try:
                    start_s, width_s = param.split("+", 1)
                    start, width = int(start_s), int(width_s)
                except ValueError:
                    raise ValueError(
                        f"chaos partition param {param!r} must be S+W "
                        "(1-based start call + window width)"
                    ) from None
                if start < 1 or width < 1:
                    raise ValueError(
                        f"chaos partition window {param!r} must have "
                        "S >= 1 and W >= 1"
                    )
                out[point] = _PointSpec(
                    kind, part_start=start, part_width=width
                )
            else:
                raise ValueError(
                    f"unknown chaos kind {kind!r}; one of {', '.join(KINDS)}"
                )
        return out

    def decide(self, point: str) -> Tuple[str, float]:
        """Advance the point's counter and return ("none"|"error"|"delay",
        delay_s).  Deterministic given (seed, call index)."""
        sp = self.points.get(point)
        if sp is None:
            return ("none", 0.0)
        with self._lock:
            self._counters[point] += 1
            n = self._counters[point]
            # draw ALWAYS (even for error_at/delay) so the schedule depends
            # only on the call index, never on which spec kind is active
            draw = self._rngs[point].random()
        if sp.kind == "error" and draw < sp.prob:
            return ("error", 0.0)
        if sp.kind == "error_at" and n in sp.at:
            return ("error", 0.0)
        if sp.kind == "delay":
            return ("delay", sp.delay_s)
        if (
            sp.kind == "partition"
            and sp.part_start <= n < sp.part_start + sp.part_width
        ):
            # inside the outage window every call fails; past it the
            # point has healed and never fires again
            return ("error", 0.0)
        return ("none", 0.0)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


_active: Optional[ChaosInjector] = None
_env_loaded = False
_install_lock = threading.Lock()


def _record(point: str) -> None:
    from dnet_tpu_torch.obs import metric  # lazy: avoid import-time registry work

    metric("dnet_chaos_injected_total").labels(point=point).inc()


def get_chaos() -> Optional[ChaosInjector]:
    """The active injector: whatever install_chaos() set, else DNET_CHAOS
    from settings (read once; tests use install_chaos/clear_chaos)."""
    global _active, _env_loaded
    if _active is not None:
        return _active
    if _env_loaded:
        return None
    with _install_lock:
        if _active is None and not _env_loaded:
            from dnet_tpu_torch.config import chaos_settings

            s = chaos_settings()
            if s.chaos:
                _active = ChaosInjector(s.chaos, seed=s.chaos_seed)
                log.warning(
                    "CHAOS ACTIVE: %s (seed=%d)", s.chaos, s.chaos_seed
                )
            _env_loaded = True
    return _active


def validate_startup(role: str = "server") -> Optional[ChaosInjector]:
    """Server-start gate: parse DNET_CHAOS NOW and fail fast on a
    malformed spec (unknown point/kind) with the declared vocabulary in
    the error, instead of silently deferring the ValueError to the first
    injection mid-request.  When chaos IS armed, pre-touch every declared
    point's counter series (so armed-but-never-fired points are visible
    in the exposition) and log one prominent warning naming the armed
    points — an injected fault must never masquerade as a real incident.
    """
    try:
        c = get_chaos()
    except ValueError as exc:
        raise SystemExit(
            f"malformed DNET_CHAOS: {exc}\n"
            f"  declared points: {', '.join(INJECTION_POINTS)}\n"
            f"  declared kinds:  {', '.join(KINDS)}"
        ) from exc
    if c is None:
        return None
    from dnet_tpu_torch.obs import metric  # lazy: avoid import-time registry work

    for point in INJECTION_POINTS:
        metric("dnet_chaos_injected_total").labels(point=point)
    log.warning(
        "=" * 64 + "\n"
        "CHAOS ARMED on this %s: spec=%r seed=%d points=%s\n"
        "Faults below are INJECTED — check /health `chaos` before paging.\n"
        + "=" * 64,
        role, c.spec, c.seed,
        ",".join(f"{p}:{sp.kind}" for p, sp in sorted(c.points.items())),
    )
    return c


def armed_summary() -> Optional[Dict[str, object]]:
    """The /health `chaos` section: active spec/seed and point->kind map,
    or None when no chaos is armed (the section is omitted entirely)."""
    try:
        c = get_chaos()
    except ValueError:
        # malformed env spec outside the server path (validate_startup
        # would have exited); surface that it is armed-but-broken
        return {"spec": "<malformed>", "seed": 0, "points": {}}
    if c is None:
        return None
    return {
        "spec": c.spec,
        "seed": c.seed,
        "points": {p: sp.kind for p, sp in sorted(c.points.items())},
    }


def install_chaos(spec: str, seed: int = 0) -> ChaosInjector:
    """Install an injector programmatically (tests); counters start at 0."""
    global _active
    with _install_lock:
        _active = ChaosInjector(spec, seed=seed)
    return _active


def clear_chaos() -> None:
    global _active, _env_loaded
    with _install_lock:
        _active = None
        _env_loaded = True  # do not fall back to the env spec mid-test


def inject(point: str) -> None:
    """Synchronous injection site (compute thread): may sleep or raise."""
    c = get_chaos()
    if c is None:
        return
    act, delay_s = c.decide(point)
    if act == "delay":
        _record(point)
        time.sleep(delay_s)
    elif act == "error":
        _record(point)
        raise ChaosError(f"chaos injected at {point}")


async def inject_async(point: str) -> None:
    """Event-loop injection site: may await or raise."""
    import asyncio

    c = get_chaos()
    if c is None:
        return
    act, delay_s = c.decide(point)
    if act == "delay":
        _record(point)
        await asyncio.sleep(delay_s)
    elif act == "error":
        _record(point)
        raise ChaosError(f"chaos injected at {point}")
