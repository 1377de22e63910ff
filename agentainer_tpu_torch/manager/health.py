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

Reference: ``agentainer_tpu/manager/health.py`` — ``HealthMonitor``;
``ReplicaMonitor`` comes with the fleet slice.
"""

from __future__ import annotations

import asyncio
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
