"""Health monitor — engine liveness checks with auto-restart escalation.

Re-implements the reference monitor (internal/health/monitor.go): one
monitoring loop per agent on the agent's configured cadence (defaults
30s/5s/3 retries, monitor.go:117-129); a check probes the agent's health
endpoint; 2xx → healthy, anything else increments the failure count
(monitor.go:245-250); when failures reach the retry cap and the agent has
auto-restart, the manager restarts it and the counter resets
(monitor.go:273-297). Status is cached in memory and stored at
``health:{id}`` with a 24h TTL (monitor.go:267-270).

Fixed vs the reference: monitoring follows the ``agent:status:*`` bus with a
real pattern subscription (the reference's Subscribe-with-glob never fired,
monitor.go:299-332), and checks go straight to the engine instead of looping
through the public proxy with a hardcoded bearer token (monitor.go:225-234).

Hardening: restart failures are counted and logged instead of
swallowed, store writes/reads cannot kill a monitor loop (the in-memory
status cache keeps answering during a store outage), and the exported
status folds in the restart watcher's crash-loop accounting so a FAILED
agent's reason is visible from ``agentainer health``.

Reference: ``agentainer_tpu/manager/health.py`` — ``HealthMonitor`` and the
fleet's ``ReplicaMonitor`` (heartbeat leases, ALIVE → SUSPECT → DEAD).
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Awaitable, Callable

from .. import faults
from ..core.spec import AgentStatus, HealthCheckConfig
from ..manager.agents import AgentManager
from ..store.base import Store
from ..store.schema import HEALTH_TTL_S, Keys

Dispatch = Callable[..., Awaitable[tuple[int, dict, bytes]]]


class HealthMonitor:
    def __init__(
        self, manager: AgentManager, store: Store, dispatch: Dispatch, logs=None
    ):
        self.manager = manager
        self.store = store
        self.dispatch = dispatch
        self.logs = logs  # LogPlane (optional): restart/store failures land here
        self._tasks: dict[str, asyncio.Task] = {}
        self._status: dict[str, dict] = {}
        self._unsub = None
        self.restarts_total = 0
        self.restart_failures_total = 0
        self.store_errors_total = 0
        self.loop_errors_total = 0

    def _warn(self, msg: str, agent_id: str = "") -> None:
        if self.logs is not None:
            try:
                self.logs.warn("health", msg, agent_id=agent_id)
                return
            except Exception:
                pass  # the log plane itself may be store-backed
        print(f"[health] {msg}", flush=True)

    async def start(self) -> None:
        """Attach to the status bus and begin monitoring running agents."""
        loop = asyncio.get_running_loop()

        def on_status(channel: str, message: str) -> None:
            agent_id = channel.rsplit(":", 1)[-1]
            if message == AgentStatus.RUNNING.value:
                loop.call_soon_threadsafe(self.start_monitoring, agent_id)
            elif message in (
                AgentStatus.STOPPED.value,
                AgentStatus.PAUSED.value,
                # crash-looped agents are terminal until an operator start/
                # resume: keeping the monitor's own restart escalation going
                # would override the watcher's give-up decision
                AgentStatus.FAILED.value,
            ):
                loop.call_soon_threadsafe(self.stop_monitoring, agent_id)

        self._unsub = self.store.on_message(Keys.STATUS_CHANNEL_PATTERN, on_status)
        for agent in self.manager.list_agents(sync_first=False):
            if agent.status == AgentStatus.RUNNING and agent.health_check:
                self.start_monitoring(agent.id)

    async def stop(self) -> None:
        if self._unsub:
            self._unsub()
        for task in list(self._tasks.values()):
            task.cancel()
        for task in list(self._tasks.values()):
            try:
                await task
            except asyncio.CancelledError:
                pass
        self._tasks.clear()

    def start_monitoring(self, agent_id: str) -> None:
        if agent_id in self._tasks and not self._tasks[agent_id].done():
            return
        agent = self.manager.try_get(agent_id)
        if agent is None or agent.health_check is None:
            return
        self._tasks[agent_id] = asyncio.create_task(
            self._monitor_loop(agent_id, agent.health_check), name=f"health-{agent_id}"
        )

    def stop_monitoring(self, agent_id: str) -> None:
        task = self._tasks.pop(agent_id, None)
        if task:
            task.cancel()

    def get_status(self, agent_id: str) -> dict:
        cached = self._status.get(agent_id)
        if cached is None:
            try:
                cached = self.store.get_json(Keys.health(agent_id))
            except Exception:
                self.store_errors_total += 1
                cached = None
        status = dict(
            cached or {"agent_id": agent_id, "status": "unknown", "failures": 0}
        )
        # fold in the restart watcher's crash-loop view: a FAILED agent's
        # health answer must say WHY (rapid-death cap, recorded reason)
        watch = self._watch_stats(agent_id)
        if watch is not None:
            status["restarts"] = watch.get("restarts", 0)
            if watch.get("crash_looping"):
                status["status"] = "crash-loop"
                status["failed_reason"] = watch.get("failed_reason")
            elif watch.get("respawn_backoff_s"):
                status["respawn_backoff_s"] = watch["respawn_backoff_s"]
        return status

    def _watch_stats(self, agent_id: str) -> dict | None:
        fn = getattr(self.manager.backend, "watch_stats", None)
        if fn is None:
            return None
        try:
            agent = self.manager.try_get(agent_id)
            if agent is None or not agent.engine_id:
                return None
            return fn(agent.engine_id)
        except Exception:
            return None

    def get_all_statuses(self) -> dict[str, dict]:
        return dict(self._status)

    async def _monitor_loop(self, agent_id: str, cfg: HealthCheckConfig) -> None:
        failures = 0
        while True:
            try:
                healthy = await self.check_once(agent_id, cfg)
                failures = 0 if healthy else failures + 1
                self._record(agent_id, healthy, failures)
                if failures >= cfg.retries:
                    agent = self.manager.try_get(agent_id)
                    if agent is None:
                        return
                    watch = self._watch_stats(agent_id) or {}
                    if watch.get("crash_looping") or watch.get("respawn_pending"):
                        # the restart WATCHER owns this engine's recovery:
                        # it is mid-backoff or has given up after the
                        # rapid-death cap. A monitor-driven restart would
                        # clear that latch (start re-arms the policy) and
                        # reinstate exactly the indefinite loop the cap
                        # exists to terminate — automated escalation defers
                        # to the watcher; only an operator start/resume
                        # overrides a crash loop.
                        failures = 0
                    elif agent.auto_restart:
                        # restart escalation (monitor.go:273-297) — a failed
                        # restart is counted + logged, never swallowed: a
                        # monitor that silently can't restart its agent is
                        # indistinguishable from one that never noticed
                        try:
                            await asyncio.to_thread(self.manager.restart, agent_id)
                            self.restarts_total += 1
                        except Exception as e:
                            self.restart_failures_total += 1
                            self._warn(
                                f"restart of {agent_id} failed: "
                                f"{type(e).__name__}: {e}",
                                agent_id=agent_id,
                            )
                        failures = 0
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a store blip in try_get/_record must degrade ONE check,
                # not kill the monitor task for the agent's whole lifetime
                self.loop_errors_total += 1
                self._warn(
                    f"monitor tick for {agent_id} errored: {type(e).__name__}: {e}",
                    agent_id=agent_id,
                )
            await asyncio.sleep(cfg.interval_s)

    async def check_once(self, agent_id: str, cfg: HealthCheckConfig) -> bool:
        try:
            # async variant: an injected probe delay must stall only this
            # check, never the daemon's event loop
            await faults.fire_async("health.probe")
            status, _, _ = await asyncio.wait_for(
                self.dispatch(agent_id, "GET", cfg.endpoint, {}, b"", request_id=""),
                timeout=cfg.timeout_s,
            )
        except Exception:
            return False
        return 200 <= status < 300

    def _record(self, agent_id: str, healthy: bool, failures: int) -> None:
        status = {
            "agent_id": agent_id,
            "status": "healthy" if healthy else "unhealthy",
            "failures": failures,
            "last_check": time.time(),
        }
        self._status[agent_id] = status
        try:
            self.store.set_json(Keys.health(agent_id), status, ttl=HEALTH_TTL_S)
        except Exception as e:
            # the in-memory cache above still answers get_status during the
            # outage; losing one durable health sample is the degradation
            self.store_errors_total += 1
            self._warn(
                f"health record for {agent_id} not persisted: "
                f"{type(e).__name__}: {e}",
                agent_id=agent_id,
            )


# per-replica lease states (mirrored into server/router.py's exclusion set)
REPLICA_ALIVE = "alive"
REPLICA_SUSPECT = "suspect"
REPLICA_DEAD = "dead"


class ReplicaMonitor:
    """Heartbeat-lease plane for multi-replica agents.

    Every ``lease_interval_s`` the monitor probes each replica of each
    RUNNING multi-replica agent directly (``Backend.probe_engine`` — the
    process-level truth, not the routed proxy path, which would mask a
    dead replica behind its healthy peers). A successful probe refreshes
    the replica's store lease (TTL ``lease_ttl_s``); probe failures leave
    the lease to age out. The per-replica state machine runs on observed
    lease age:

        ALIVE    probe ok, or lease younger than suspect_after_s
        SUSPECT  lease age in [suspect_after_s, dead_after_s) — excluded
                 from routing but not yet repaired (a GC pause or network
                 blip must not trigger a respawn storm)
        DEAD     lease age >= dead_after_s (or the engine record is gone)
                 — routing excludes it AND fleet repair runs: respawn +
                 journaled in-flight reassignment + session-affinity drop

    Single-replica agents are skipped entirely: their liveness remains
    the restart watcher + health monitor's job, and ``fleet.replicas=1``
    deployments see zero new probe traffic (the A/B baseline).

    The ``replica.lease`` failpoint cuts the lease REFRESH: firing it
    models a replica whose heartbeats stop while the process still serves
    (lease-expiry flapping).
    """

    def __init__(
        self,
        manager: AgentManager,
        store: Store,
        router=None,
        repair=None,
        lease_ttl_s: float = 6.0,
        lease_interval_s: float = 1.0,
        suspect_after_s: float = 3.0,
        dead_after_s: float = 6.0,
        logs=None,
    ):
        self.manager = manager
        self.store = store
        self.router = router  # ReplicaRouter (exclusion feed); optional
        self.repair = repair  # FleetRepair (DEAD escalation); optional
        self.lease_ttl_s = lease_ttl_s
        self.lease_interval_s = lease_interval_s
        self.suspect_after_s = suspect_after_s
        self.dead_after_s = dead_after_s
        self.logs = logs
        self._task: asyncio.Task | None = None
        # engine_id -> (state, last-observed lease timestamp). Mutated on
        # the monitor's worker thread, read from the event loop (metrics)
        # — every access goes through _state_lock because a
        # concurrent del during iteration/copy raises at the read site.
        self._state_lock = threading.Lock()
        self._states: dict[str, tuple[str, float]] = {}
        self.lease_refreshes_total = 0
        self.lease_errors_total = 0
        self.suspects_total = 0
        self.deaths_total = 0
        self.probe_errors_total = 0
        self.log_errors_total = 0
        self.repair_errors_total = 0

    def _warn(self, msg: str, agent_id: str = "") -> None:
        from .audit import warn_fallback

        if not warn_fallback(self.logs, "fleet", msg, agent_id=agent_id):
            self.log_errors_total += 1

    def states(self, agent_id: str | None = None) -> dict[str, str]:
        with self._state_lock:
            snap = dict(self._states)
        if agent_id is None:
            return {eid: s for eid, (s, _) in snap.items()}
        agent = self.manager.try_get(agent_id)
        if agent is None:
            return {}
        return {
            eid: snap.get(eid, (REPLICA_ALIVE, 0.0))[0]
            for eid in agent.all_engine_ids()
        }

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop(), name="replica-monitor")

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.lease_interval_s)
            try:
                await asyncio.to_thread(self.tick)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a store blip degrades one tick, never the monitor; the
                # lease keys simply age until the next successful pass
                self.lease_errors_total += 1
                self._warn(f"replica monitor tick errored: {e!r}")

    def tick(self) -> None:
        """One probe/lease/classify pass over every multi-replica agent."""
        seen: set[str] = set()
        for agent in self.manager.list_agents(sync_first=False):
            ids = agent.all_engine_ids()
            if len(ids) <= 1 or agent.status != AgentStatus.RUNNING:
                continue
            for eid in ids:
                seen.add(eid)
                self._check_replica(agent, eid)
        # replicas that no longer belong to any agent (replaced, scaled
        # down, or their agent removed): drop tracked state AND tell the
        # router to forget them — dead-pinned health entries, per-replica
        # breakers, and session affinities for retired engine ids would
        # otherwise accumulate for the daemon's whole lifetime
        with self._state_lock:
            stale = [e for e in self._states if e not in seen]
            for eid in stale:
                del self._states[eid]
        for eid in stale:
            if self.router is not None:
                self.router.forget(eid)

    def _check_replica(self, agent, engine_id: str) -> None:
        now = time.time()
        info = self.manager.backend.engine_info(engine_id)
        probed = False
        if info is not None:
            try:
                probed = self.manager.backend.probe_engine(engine_id)
            except Exception:
                # a raising probe is a failed probe, but count it: a
                # backend bug here would silently SUSPECT healthy replicas
                self.probe_errors_total += 1
                probed = False
        if probed:
            try:
                faults.fire("replica.lease")
                self.store.set_json(
                    Keys.replica_lease(agent.id, engine_id),
                    {"engine_id": engine_id, "agent_id": agent.id, "at": now},
                    ttl=self.lease_ttl_s,
                )
                self.lease_refreshes_total += 1
                self._transition(agent, engine_id, REPLICA_ALIVE, now)
                self._feed_router_load(engine_id)
                return
            except Exception:
                # refresh failed (store blip or injected lease fault): the
                # replica SERVES but its lease ages — classify by lease age
                # below, exactly like a replica whose heartbeats stopped
                self.lease_errors_total += 1
        if info is None:
            # engine record vanished: no process to come back — straight to
            # DEAD (the repair path re-creates from the agent record)
            self._transition(agent, engine_id, REPLICA_DEAD, now)
            return
        ok, lease_at = self._lease_at(agent.id, engine_id)
        if not ok:
            # the STORE is unreadable, not the replica: classifying a
            # failed read as an expired lease would mass-DEAD healthy
            # replicas during a store blip and fire a repair storm — keep
            # the prior state for this tick (counted; the next successful
            # pass re-classifies honestly)
            return
        age = now - lease_at if lease_at is not None else float("inf")
        if age >= self.dead_after_s:
            self._transition(agent, engine_id, REPLICA_DEAD, now)
        elif age >= self.suspect_after_s:
            self._transition(agent, engine_id, REPLICA_SUSPECT, now)
        # else: lease still fresh — keep the current state (a single missed
        # probe inside the suspect window is not an event)

    def _feed_router_load(self, engine_id: str) -> None:
        """Push the replica's ENGINE-reported occupancy to the router's
        p2c signal: queue depth + waiting lanes + active lanes from the
        engine's own /metrics. The proxy-side in-flight count only sees
        this proxy's dispatches; the engine's admission picture also
        counts journal replays and lanes still decoding after their HTTP
        response settled. Best-effort: a failed sample keeps the router
        on its previous value (or the in-flight fallback)."""
        if self.router is None:
            return
        try:
            stats = self.manager.backend.stats(engine_id)
            if not stats:
                return
            depth = (
                int(stats.get("queue_depth", 0) or 0)
                + int(stats.get("waiting_depth", 0) or 0)
                + int(stats.get("active_requests", 0) or 0)
            )
            self.router.set_load(engine_id, depth)
        except Exception:
            # a malformed sample must not fail the probe pass (counted)
            self.probe_errors_total += 1

    def _lease_at(self, agent_id: str, engine_id: str) -> tuple[bool, float | None]:
        """(read_ok, lease timestamp | None). ok=False means the store
        itself errored — indistinguishable from a fine lease, so callers
        must not treat it as expiry; None with ok=True means the lease
        genuinely aged out (TTL) or was never written."""
        try:
            doc = self.store.get_json(Keys.replica_lease(agent_id, engine_id))
        except Exception:
            self.lease_errors_total += 1
            return False, None
        if doc is None:
            return True, None
        try:
            return True, float(doc.get("at", 0.0))
        except (TypeError, ValueError):
            return True, None

    def _transition(self, agent, engine_id: str, state: str, now: float) -> None:
        with self._state_lock:
            prev = self._states.get(engine_id, (REPLICA_ALIVE, 0.0))[0]
            self._states[engine_id] = (state, now)
        if self.router is not None:
            self.router.set_health(engine_id, state)
        if state == prev:
            return
        if state == REPLICA_SUSPECT:
            self.suspects_total += 1
        self._warn(
            f"replica {engine_id} of {agent.id}: {prev} -> {state}",
            agent_id=agent.id,
        )
        if state == REPLICA_DEAD:
            self.deaths_total += 1
            if self.router is not None:
                self.router.on_replica_dead(agent.id, engine_id)
            if self.repair is not None:
                try:
                    self.repair.repair_replica(agent.id, engine_id)
                except Exception as e:
                    # repair failure leaves the replica DEAD (excluded) —
                    # the next DEAD observation retries; counted + logged
                    self.repair_errors_total += 1
                    self._warn(
                        f"repair of {engine_id} failed: {e!r}",
                        agent_id=agent.id,
                    )

    def stats(self) -> dict:
        with self._state_lock:
            snap = dict(self._states)
        return {
            "lease_refreshes_total": self.lease_refreshes_total,
            "lease_errors_total": self.lease_errors_total,
            "suspects_total": self.suspects_total,
            "deaths_total": self.deaths_total,
            "replicas": {eid: s for eid, (s, _) in snap.items()},
        }
