"""Failure detection and elastic recovery for the ring.

Counterpart of dnet_tpu/api/failure.py `RingFailureMonitor`, started on
every ring (api/server.py).  It treats membership as dynamic state
(membership/) rather than a one-shot solve:

- a periodic gRPC HealthCheck of every shard in the active topology
  (DNET_API_HEALTH_INTERVAL_S, +-10% jitter);
- after DNET_API_HEALTH_FAIL_THRESHOLD consecutive failures a shard is
  DOWN: in-flight requests fail fast (their token futures resolve with an
  error instead of waiting out the request timeout) and new requests are
  refused with a 503;
- with auto_recover (the API's --auto-recover) the monitor re-profiles the
  cluster, re-solves the topology over the healthy shards
  (parallel/solver.py) and reloads the ring through the DELTA path, so
  shards whose load body is unchanged keep their weights and only take the
  new epoch.  Every re-solve mints a fresh epoch (ClusterManager.
  install_topology): the fenced-out shard's late frames, tokens and resets
  are rejected, not computed;
- recovery is convergent: a shard that dies while a recovery is reloading
  is picked up by the bounded-round loop (DNET_RECOVERY_MAX_ROUNDS), and a
  failed reload retries under the `load_model` backoff class before the
  previous topology is restored;
- fenced-out shards move to a QUARANTINE list that is still probed every
  tick; with DNET_REJOIN=1 a shard green for DNET_REJOIN_STABLE_S triggers
  a re-profile + re-solve through the same delta path
  (dnet_shard_rejoins_total).

Each round counts dnet_recovery_total{outcome} and observes
dnet_recovery_duration_seconds.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from dnet_tpu_torch.core.types import DeviceInfo
from dnet_tpu_torch.membership import QuarantineSet
from dnet_tpu_torch.obs import metric
from dnet_tpu_torch.obs.events import log_event
from dnet_tpu_torch.resilience import chaos
from dnet_tpu_torch.resilience.policy import call_with_retry
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

_RECOVERY = metric("dnet_recovery_total")
_RECOVERY_S = metric("dnet_recovery_duration_seconds")
_REJOINS = metric("dnet_shard_rejoins_total")


@dataclass
class ShardHealth:
    instance: str
    consecutive_failures: int = 0
    last_ok: float = field(default_factory=time.monotonic)
    down: bool = False


class RingFailureMonitor:
    def __init__(
        self,
        cluster_manager,
        inference_manager,
        model_manager=None,
        interval_s: float = 5.0,
        fail_threshold: int = 3,
        timeout_s: float = 3.0,
        auto_recover: bool = False,
        ring_client_factory: Optional[Callable[[str], object]] = None,
        rejoin: Optional[bool] = None,
        rejoin_stable_s: Optional[float] = None,
        recovery_max_rounds: Optional[int] = None,
    ) -> None:
        from dnet_tpu_torch.config import membership_settings
        from dnet_tpu_torch.transport.grpc_transport import RingClient

        self.cluster = cluster_manager
        self.inference = inference_manager
        self.model_manager = model_manager
        self.interval_s = interval_s
        self.fail_threshold = fail_threshold
        self.timeout_s = timeout_s
        self.auto_recover = auto_recover
        ms = membership_settings()
        self.rejoin_enabled = ms.rejoin if rejoin is None else bool(rejoin)
        self.rejoin_stable_s = (
            ms.rejoin_stable_s if rejoin_stable_s is None
            else float(rejoin_stable_s)
        )
        self.max_recovery_rounds = max(
            ms.recovery_max_rounds if recovery_max_rounds is None
            else int(recovery_max_rounds),
            1,
        )
        self._make_client = ring_client_factory or (lambda addr: RingClient(addr))
        self.health: Dict[str, ShardHealth] = {}
        # fenced-out shards, still probed (dnet_tpu/membership/quarantine.py)
        self.quarantine = QuarantineSet()
        self._clients: Dict[str, object] = {}  # addr -> RingClient (persistent)
        self._task: Optional[asyncio.Task] = None
        self._recovering = False
        self._jitter = random.Random()

    # ---- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        """Awaited shutdown: cancel + reap the probe task and close every
        cached channel IN this loop.  (The old fire-and-forget
        ensure_future(close) leaked channels whenever the loop tore down
        before the close tasks ran.)"""
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            except Exception:
                log.exception("failure monitor task died during stop")
        clients, self._clients = self._clients, {}
        # independent channel closes: one slow/broken channel must not
        # serialize the rest of shutdown behind its close handshake
        outcomes = await asyncio.gather(
            *(c.close() for c in clients.values()), return_exceptions=True
        )
        for exc in outcomes:
            if isinstance(exc, Exception):
                log.debug("channel close failed during stop: %s", exc)

    # ---- state ----------------------------------------------------------
    @property
    def degraded(self) -> bool:
        return any(h.down for h in self.health.values())

    def down_shards(self) -> List[str]:
        return [h.instance for h in self.health.values() if h.down]

    def snapshot(self) -> dict:
        return {
            h.instance: {
                "down": h.down,
                "consecutive_failures": h.consecutive_failures,
                "seconds_since_ok": round(time.monotonic() - h.last_ok, 1),
            }
            for h in self.health.values()
        }

    # ---- monitoring ------------------------------------------------------
    async def _loop(self) -> None:
        while True:
            try:
                await self._tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("failure monitor tick crashed")
            # +-10% jitter: a large ring's monitors must not probe every
            # shard in lockstep (synchronized probe bursts alias with the
            # decode cadence and can themselves trip timeouts under load)
            await asyncio.sleep(
                self.interval_s * (1.0 + self._jitter.uniform(-0.1, 0.1))
            )

    async def _tick(self) -> None:
        topo = self.cluster.current_topology
        if topo is None:
            self.health.clear()
            self.quarantine.clear()  # no topology, nothing to rejoin into
            await self._prune_clients(keep=set())
            return
        by_instance = {d.instance: d for d in topo.devices}
        # drop state (and cached channels) for shards no longer in the
        # topology — quarantined shards keep their channels: they are
        # probed below, and a rejoin reuses the same address
        for gone in set(self.health) - set(by_instance):
            del self.health[gone]
        # a shard the CURRENT topology includes is an active member again
        # (an operator re-prepare readmitted it): its quarantine entry is
        # stale and must not keep shadow-probing it
        for back in [
            i for i in self.quarantine.instances() if i in by_instance
        ]:
            self.quarantine.remove(back)
        keep = {f"{d.host}:{d.grpc_port}" for d in by_instance.values()}
        keep |= {q.addr for q in self.quarantine.shards()}
        await self._prune_clients(keep=keep)

        async def check(dev: DeviceInfo) -> None:
            h = self.health.setdefault(dev.instance, ShardHealth(dev.instance))
            addr = f"{dev.host}:{dev.grpc_port}"
            client = self._clients.get(addr)
            if client is None:
                client = self._clients[addr] = self._make_client(addr)
            try:
                # chaos point: an injected fault counts as a probe failure,
                # driving the same DOWN/recovery transitions as a real one
                await chaos.inject_async("health_check")
                await client.health_check(timeout=self.timeout_s)
                h.consecutive_failures = 0
                h.last_ok = time.monotonic()
                if h.down:
                    log.info("shard %s is back", dev.instance)
                    h.down = False
            except Exception as exc:
                h.consecutive_failures += 1
                log.warning(
                    "health check %s failed (%d/%d): %s",
                    dev.instance, h.consecutive_failures, self.fail_threshold, exc,
                )
                if not h.down and h.consecutive_failures >= self.fail_threshold:
                    h.down = True
                    await self._on_shard_down(dev.instance)

        await asyncio.gather(*(check(by_instance[i]) for i in by_instance))
        await self._probe_quarantine()

    async def _prune_clients(self, keep: set) -> None:
        stale = [
            (addr, self._clients.pop(addr))
            for addr in set(self._clients) - keep
        ]
        outcomes = await asyncio.gather(
            *(client.close() for _, client in stale), return_exceptions=True
        )
        for (addr, _), exc in zip(stale, outcomes):
            if isinstance(exc, Exception):
                log.debug("pruned channel close failed for %s: %s", addr, exc)

    # ---- failure handling -------------------------------------------------
    async def _on_shard_down(self, instance: str) -> None:
        log.error("shard %s marked DOWN", instance)
        # fail in-flight requests fast instead of letting them burn the
        # full await_token timeout (request_timeout_s, api/inference.py)
        adapter = self.inference.adapter
        if adapter is not None:  # topology may exist before any model load
            adapter.fail_pending(f"shard {instance} is unreachable")
        if self.auto_recover:
            if self._recovering:
                # a second failure during an in-flight recovery: the shard
                # is already marked down, and the recovery loop re-checks
                # down_shards() after each reload — deferring here (instead
                # of the old silent early-return) is what makes recovery
                # convergent
                log.warning(
                    "shard %s down during active recovery; deferred to the "
                    "convergence loop", instance,
                )
                return
            await self._recover_loop()

    # ---- recovery ---------------------------------------------------------
    async def _recover_loop(self) -> None:
        """Re-solve + reload until the surviving ring is stable, bounded by
        `max_recovery_rounds`.  Each round's outcome is counted
        (dnet_recovery_total{outcome=}) and timed."""
        if self._recovering or self.model_manager is None:
            return
        self._recovering = True
        try:
            for round_no in range(1, self.max_recovery_rounds + 1):
                model_id = self.inference.model_id
                topo = self.cluster.current_topology
                if model_id is None or topo is None:
                    return
                t0 = time.monotonic()
                try:
                    outcome = await self._recover_once(model_id, topo)
                except Exception:
                    log.exception("auto-recovery round %d crashed", round_no)
                    outcome = "failed"
                _RECOVERY.labels(outcome=outcome).inc()
                _RECOVERY_S.observe(time.monotonic() - t0)
                log_event(
                    "recovery_round", outcome=outcome, round_no=round_no,
                    duration_s=round(time.monotonic() - t0, 3),
                )
                if outcome != "recovered":
                    log.error(
                        "recovery round %d ended %s; staying degraded "
                        "(next DOWN transition re-enters)", round_no, outcome,
                    )
                    return
                # convergence: shards that died DURING the reload are
                # already marked down (their _on_shard_down deferred here)
                still_down = self.down_shards()
                if not still_down:
                    return
                log.warning(
                    "shard(s) %s went down during recovery; re-solving "
                    "(round %d/%d)",
                    still_down, round_no + 1, self.max_recovery_rounds,
                )
            log.error(
                "recovery did not converge within %d rounds; staying "
                "degraded", self.max_recovery_rounds,
            )
        finally:
            self._recovering = False

    async def _recover_once(self, model_id: str, topo) -> str:
        """One re-solve + delta reload over the currently healthy shards.
        Returns a RECOVERY_OUTCOMES value."""
        # re-profile so the solver sees real capacities (healthy_devices
        # alone returns unprofiled DeviceInfo whose zeroed hbm_bytes would
        # disable the feasibility check), and never re-include a shard
        # this monitor holds DOWN or QUARANTINED — its HTTP /health may
        # still answer 200 while its gRPC data plane is dead.
        down = set(self.down_shards())
        healthy = [
            d
            for d in await self.cluster.profile_cluster()
            if d.instance not in down and d.instance not in self.quarantine
        ]
        outcome = await self._reconfigure(healthy, model_id, topo)
        if outcome != "recovered":
            return outcome
        new_topo = self.cluster.current_topology
        log.info(
            "recovered: epoch %d over %d shard(s); quarantine now %s",
            getattr(new_topo, "epoch", 0),
            len(new_topo.assignments),
            sorted(self.quarantine.instances()) or "empty",
        )
        return "recovered"

    async def _reconfigure(self, healthy: List[DeviceInfo], model_id: str, old_topo) -> str:
        """Solve over `healthy`, install (epoch mint), and delta-reload —
        restoring `old_topo` when the reload fails after retries.  The
        shared tail of failure recovery and rejoin."""
        if not healthy:
            log.error("no healthy shards left; cannot reconfigure")
            return "no_capacity"
        unprofiled = [d.instance for d in healthy if not d.hbm_bytes]
        if unprofiled:
            log.warning(
                "reconfiguring with unprofiled shard(s) %s: "
                "memory-feasibility check degraded", unprofiled,
            )
        from dnet_tpu_torch.api.catalog import split_variant
        from dnet_tpu_torch.api.model_manager import resolve_model_dir
        from dnet_tpu_torch.parallel.solver import (
            model_profile_from_checkpoint,
            solve_topology,
        )

        # a quant variant's layers are its base checkpoint's
        model_dir = resolve_model_dir(split_variant(model_id)[0], self.model_manager.models_dir)
        if model_dir is None:
            log.error("model %s no longer resolvable; cannot reconfigure", model_id)
            return "no_capacity"
        # size KV the way the serving path does (seq_len + kv_bits feed
        # the solver's memory model; a bare default would mis-size KV)
        profile = model_profile_from_checkpoint(
            model_dir,
            seq_len=getattr(self.model_manager, "max_seq", 4096),
            kv_bits=old_topo.kv_bits,
            weight_quant_bits=getattr(
                self.model_manager, "weight_quant_bits", 0
            ),
        )
        try:
            new_topo = solve_topology(healthy, profile, kv_bits=old_topo.kv_bits)
        except ValueError as exc:
            log.error("re-solve failed (%s); staying as-is", exc)
            return "no_capacity"
        new_topo.model = model_id
        # install mints the next epoch — the fence against the shards this
        # solve leaves out.  If the reload fails the OLD topology (and its
        # already-minted epoch) must come back, or the dead shard would
        # drop out of monitoring and the API would accept requests against
        # a ring that never loaded.
        self.cluster.install_topology(new_topo)
        try:
            # delta reload: unchanged shards keep weights, only bump
            # epoch; transient failures retry under the load_model class
            # (its own backoff scale) instead of silently never retrying
            await call_with_retry(
                lambda: self.model_manager.load_model(model_id, delta=True),
                method="load_model",
                retryable=lambda exc: not isinstance(exc, FileNotFoundError),
            )
        except Exception:
            log.exception(
                "reload failed after retries; restoring previous topology"
            )
            self.cluster.restore_topology(old_topo)
            # the aborted epoch may have PARTIALLY shipped: shards that
            # already took /update_topology (or a full load) hold the new
            # epoch and would fence the restored adapter forever — fatal
            # on the rejoin path, where the ring was healthy and serving.
            # Re-ship the restored topology best-effort (delta: unchanged
            # shards just re-pin the old epoch).  On the failure path this
            # usually fails too (the old topology contains the dead
            # shard) — the ring stays degraded exactly as before.
            try:
                await self.model_manager.load_model(model_id, delta=True)
            except Exception as exc:
                log.warning(
                    "restore fan-out incomplete (%s); ring stays degraded "
                    "until the next recovery", exc,
                )
            return "failed"
        # the fence is armed (new epoch loaded everywhere): EVERY shard of
        # the old topology the new solve left out — marked down, or
        # healthy but dropped by the solver's placement (singleton merge,
        # zero layers) — moves to quarantine.  Still probed, path back via
        # rejoin; and `degraded` clears NOW (resume replays wait on it).
        placed = {a.instance for a in new_topo.assignments}
        for dev in old_topo.devices:
            if dev.instance in placed:
                continue
            self.quarantine.add(dev)
            self.health.pop(dev.instance, None)
        return "recovered"

    # ---- quarantine + rejoin ---------------------------------------------
    async def _probe_quarantine(self) -> None:
        """Keep probing fenced-out shards (the path back to full capacity
        the old prune-forever behavior never had), and — behind
        DNET_REJOIN=1 — rejoin one shard per tick once it has stayed green
        for the stability window."""
        if not self.quarantine:
            return
        now = time.monotonic()

        async def probe(q) -> None:
            client = self._clients.get(q.addr)
            if client is None:
                client = self._clients[q.addr] = self._make_client(q.addr)
            try:
                await client.health_check(timeout=self.timeout_s)
                q.mark_green(now)
            except Exception as exc:
                q.mark_red(str(exc))

        await asyncio.gather(*(probe(q) for q in self.quarantine.shards()))
        if not self.rejoin_enabled or self._recovering:
            return
        ready = self.quarantine.ready(self.rejoin_stable_s)
        if ready:
            # one rejoin per tick: each is a full re-solve + reload, and a
            # burst of returning shards converges over a few ticks anyway
            await self._try_rejoin(ready[0])

    async def _try_rejoin(self, q) -> None:
        """Re-admit one stably green quarantined shard: re-profile with it
        included, re-solve, delta-reload.  Any failure (including an
        injected `rejoin` chaos fault) defers the shard to re-earn its
        stability window instead of hot-looping."""
        model_id = self.inference.model_id
        topo = self.cluster.current_topology
        if self.model_manager is None or model_id is None or topo is None:
            return
        self._recovering = True
        t0 = time.monotonic()
        outcome: Optional[str] = None
        try:
            try:
                # chaos point: an injected error aborts THIS attempt the
                # way any real rejoin failure would
                await chaos.inject_async("rejoin")
            except chaos.ChaosError as exc:
                log.warning("rejoin of %s aborted by chaos: %s", q.instance, exc)
                q.defer()
                return
            devices = await self.cluster.profile_cluster()
            if q.instance not in {d.instance for d in devices}:
                # gRPC probes green but the HTTP control plane isn't
                # discoverable/serving yet: not actually ready
                log.info(
                    "rejoin of %s deferred: not in profiled device set",
                    q.instance,
                )
                q.defer()
                return
            down = set(self.down_shards())
            healthy = [
                d
                for d in devices
                if d.instance not in down
                and (d.instance == q.instance or d.instance not in self.quarantine)
            ]
            outcome = await self._reconfigure(healthy, model_id, topo)
            new_topo = self.cluster.current_topology
            if outcome == "recovered" and new_topo.assignment_for(
                q.instance
            ) is not None:
                self.quarantine.remove(q.instance)
                _REJOINS.inc()
                log.info(
                    "shard %s rejoined: epoch %d over %d shard(s)",
                    q.instance,
                    getattr(new_topo, "epoch", 0),
                    len(new_topo.assignments),
                )
            else:
                if outcome == "recovered":
                    # the reload went through but the solver gave the
                    # candidate zero layers: NOT a rejoin — it stays
                    # quarantined (probed) and re-earns its window
                    log.warning(
                        "rejoin of %s: solver did not place it; staying "
                        "quarantined", q.instance,
                    )
                q.defer()
        except Exception:
            log.exception("rejoin of %s crashed", q.instance)
            outcome = outcome or "failed"
            q.defer()
        finally:
            if outcome is not None:
                _RECOVERY.labels(outcome=outcome).inc()
                _RECOVERY_S.observe(time.monotonic() - t0)
                log_event(
                    "recovery_round", outcome=outcome, kind="rejoin",
                    duration_s=round(time.monotonic() - t0, 3),
                )
            self._recovering = False
