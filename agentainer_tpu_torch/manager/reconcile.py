"""Desired-vs-actual state reconciliation.

Re-implements the reference's two reconcilers against the Backend interface:

- ``QuickSync`` — synchronous, per-agent or all; invoked after every
  lifecycle mutation and before every list (reference pkg/agentsync/
  quick_sync.go:40-143);
- ``StateSynchronizer`` — the background loop: initial sync, periodic sync
  every 10s, and push-based engine events (reference internal/sync/
  state_sync.go:44-317, Docker event subscription analogue).

State mapping parity (state_sync.go:216-229): engine running→running,
paused→paused, created/exited→stopped, anything else→failed. A *missing*
engine while the record says running/paused means the runtime lost it: mark
stopped and clear engine_id (state_sync.go:169-187). Every change persists
the record, updates the legacy status key, and publishes on
``agent:status:{id}`` — the event bus health/metrics listen on
(state_sync.go:189-212,311-317).

Reference: ``agentainer_tpu/manager/reconcile.py`` — ``QuickSync`` (with the
fleet's multi-replica state mapping), ``StateSynchronizer`` and
``FleetRepair``.
"""

from __future__ import annotations

import asyncio
import threading

from ..core.spec import Agent, AgentStatus
from ..manager.agents import AgentManager
from ..runtime.backend import Backend, EngineState


def engine_to_agent_status(state: EngineState) -> AgentStatus:
    if state == EngineState.RUNNING:
        return AgentStatus.RUNNING
    if state == EngineState.PAUSED:
        return AgentStatus.PAUSED
    if state in (EngineState.CREATED, EngineState.EXITED):
        return AgentStatus.STOPPED
    return AgentStatus.FAILED


class QuickSync:
    def __init__(self, manager: AgentManager, backend: Backend):
        self.manager = manager
        self.backend = backend
        self._lock = threading.RLock()

    def sync_agent(self, agent_id: str) -> Agent | None:
        with self._lock:
            agent = self.manager.try_get(agent_id)
            if agent is None:
                return None
            if len(agent.all_engine_ids()) > 1:
                return self._sync_fleet_agent(agent)
            new_status = agent.status
            engine_cleared = False
            if not agent.engine_id:
                # no engine yet: created stays created; a record claiming to
                # run without an engine is stale
                if agent.status in (AgentStatus.RUNNING, AgentStatus.PAUSED):
                    new_status = AgentStatus.STOPPED
            else:
                info = self.backend.engine_info(agent.engine_id)
                if info is None:
                    if agent.status in (AgentStatus.RUNNING, AgentStatus.PAUSED):
                        new_status = AgentStatus.STOPPED
                    agent.engine_id = ""
                    engine_cleared = True
                else:
                    mapped = engine_to_agent_status(info.state)
                    # a created-but-never-started engine shouldn't demote a
                    # freshly deployed agent
                    if not (
                        agent.status == AgentStatus.CREATED and info.state == EngineState.CREATED
                    ):
                        new_status = mapped
            changed = new_status != agent.status
            if changed or engine_cleared:
                agent.status = new_status
                self.manager.save_agent(agent, publish_status=changed)
            return agent

    def _sync_fleet_agent(self, agent: Agent) -> Agent:
        """Multi-replica state mapping: the agent is a FLEET, so one dead
        replica must not demote it — the agent is RUNNING while ANY replica
        runs (degraded, repaired by the fleet plane), STOPPED only when all
        replicas are down. A vanished/dead PRIMARY promotes the first live
        replica to ``engine_id`` so every primary-endpoint reader (metrics
        sampling, logs, legacy dispatch) follows a survivor."""
        infos = {eid: self.backend.engine_info(eid) for eid in agent.all_engine_ids()}
        live = [
            eid
            for eid, info in infos.items()
            if info is not None and info.state == EngineState.RUNNING
        ]
        paused = [
            eid
            for eid, info in infos.items()
            if info is not None and info.state == EngineState.PAUSED
        ]
        changed = False
        new_status = agent.status
        if live:
            new_status = AgentStatus.RUNNING
            if agent.engine_id not in live:
                agent.engine_id = live[0]
                # keep the record order primary-first for stable routing
                agent.replica_ids = live + [
                    e for e in agent.replica_ids if e not in live
                ]
                changed = True
        elif paused:
            new_status = AgentStatus.PAUSED
        elif agent.status in (AgentStatus.RUNNING, AgentStatus.PAUSED):
            new_status = AgentStatus.STOPPED
        # drop replica ids whose engine record vanished entirely (a repair
        # re-creates them with fresh ids via _start_engine)
        kept = [eid for eid in agent.replica_ids if infos.get(eid) is not None]
        if kept != agent.replica_ids:
            agent.replica_ids = kept
            if kept:
                agent.engine_id = agent.engine_id if agent.engine_id in kept else kept[0]
            changed = True
        status_changed = new_status != agent.status
        if status_changed or changed:
            agent.status = new_status
            self.manager.save_agent(agent, publish_status=status_changed)
        return agent

    def sync_all(self) -> None:
        for agent_id in list(self.manager.agent_ids()):
            self.sync_agent(agent_id)
        # prune orphaned engines: running engines whose agent record is gone
        # (the reverse direction the reference handles via agents:list
        # cleanup, state_sync.go:131-134)
        known = self.manager.agent_ids()
        for info in self.backend.list_engines():
            if info.agent_id not in known:
                try:
                    self.backend.stop_engine(info.engine_id, timeout_s=2.0)
                    self.backend.remove_engine(info.engine_id)
                except Exception:
                    pass


class StateSynchronizer:
    """Async wrapper: initial sync + periodic loop + engine-event push."""

    def __init__(self, quick_sync: QuickSync, backend: Backend, interval_s: float = 10.0):
        self.quick_sync = quick_sync
        self.backend = backend
        self.interval_s = interval_s
        self._task: asyncio.Task | None = None
        self._unsub = None
        self.sync_errors_total = 0
        self.last_error = ""

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        await asyncio.to_thread(self.quick_sync.sync_all)

        def on_event(engine_id: str, state: EngineState) -> None:
            info = self.backend.engine_info(engine_id)
            agent_id = info.agent_id if info else self._agent_for(engine_id)
            if agent_id:
                loop.call_soon_threadsafe(
                    lambda: loop.run_in_executor(None, self.quick_sync.sync_agent, agent_id)
                )

        self._unsub = self.backend.subscribe_events(on_event)
        self._task = asyncio.create_task(self._loop(), name="state-sync")

    def _agent_for(self, engine_id: str) -> str | None:
        for agent in self.quick_sync.manager.list_agents(sync_first=False):
            if agent.engine_id == engine_id:
                return agent.id
        return None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await asyncio.to_thread(self.quick_sync.sync_all)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # survive store blips (next tick retries) but visibly:
                # a reconciler that dies silently lets desired and actual
                # state drift until someone notices the hard way
                self.sync_errors_total += 1
                self.last_error = f"{type(e).__name__}: {e}"

    async def stop(self) -> None:
        if self._unsub:
            self._unsub()
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def sync_now(self) -> None:
        await asyncio.to_thread(self.quick_sync.sync_all)


class FleetRepair:
    """Fleet-wide repair: the reconciler's escalation for a DEAD replica.

    Invoked by the replica monitor on a lease-expiry death (and safe to
    call from anywhere — idempotent). Three repairs, in blast-radius
    order:

    1. **reassign the dead replica's journaled in-flight work** — every
       PROCESSING entry attributed to it returns to PENDING immediately
       and the replay worker is kicked, so orphaned dispatches re-run on a
       SURVIVOR now instead of waiting out the staleness window (the CAS +
       engine idempotency memo make the re-dispatch exactly-once);
    2. **drop routing state** — affinity entries pointing at the corpse are
       cleared (sessions hand off; their KV restores from the store
       snapshot on the survivor, token-identically);
    3. **respawn** — restart the dead engine process (or re-create it from
       the agent record when the engine vanished), restoring the fleet to
       its desired replica count. When the agent has auto_restart the
       backend's crash-loop watcher usually wins this race; start_engine
       is idempotent against an already-live engine.
    """

    def __init__(self, manager: AgentManager, journal, router=None, replay=None, logs=None):
        self.manager = manager
        self.journal = journal
        self.router = router
        self.replay = replay
        self.logs = logs
        self.repairs_total = 0
        self.reassigned_total = 0
        self.respawn_errors_total = 0
        self.log_errors_total = 0

    def repair_replica(self, agent_id: str, engine_id: str) -> dict:
        self.repairs_total += 1
        out = {"reassigned": 0, "respawned": False}
        try:
            n = self.journal.reassign_replica(agent_id, engine_id)
            self.reassigned_total += n
            out["reassigned"] = n
            if n and self.replay is not None:
                self.replay.kick_threadsafe()
        except Exception as e:
            self._warn(agent_id, f"reassign for {engine_id} failed: {e!r}")
        if self.router is not None:
            self.router.on_replica_dead(agent_id, engine_id)
        agent = self.manager.try_get(agent_id)
        if agent is None or agent.status != AgentStatus.RUNNING:
            return out  # stopped/removed agents are not repaired
        try:
            info = self.manager.backend.engine_info(engine_id)
            if info is None:
                # engine record gone: re-create missing replicas from the
                # durable agent record (same path as resume/rehydration)
                self.manager.resume(agent_id)
            else:
                self.manager.backend.start_engine(engine_id)
            out["respawned"] = True
        except Exception as e:
            self.respawn_errors_total += 1
            self._warn(agent_id, f"respawn of {engine_id} failed: {e!r}")
        return out

    def _warn(self, agent_id: str, msg: str) -> None:
        from .audit import warn_fallback

        if not warn_fallback(self.logs, "fleet-repair", msg, agent_id=agent_id):
            self.log_errors_total += 1


class StateSynchronizer:
    """Async wrapper: initial sync + periodic loop + engine-event push."""

    def __init__(self, quick_sync: QuickSync, backend: Backend, interval_s: float = 10.0):
        self.quick_sync = quick_sync
        self.backend = backend
        self.interval_s = interval_s
        self._task: asyncio.Task | None = None
        self._unsub = None
        self.sync_errors_total = 0
        self.last_error = ""

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        await asyncio.to_thread(self.quick_sync.sync_all)

        def on_event(engine_id: str, state: EngineState) -> None:
            info = self.backend.engine_info(engine_id)
            agent_id = info.agent_id if info else self._agent_for(engine_id)
            if agent_id:
                loop.call_soon_threadsafe(
                    lambda: loop.run_in_executor(None, self.quick_sync.sync_agent, agent_id)
                )

        self._unsub = self.backend.subscribe_events(on_event)
        self._task = asyncio.create_task(self._loop(), name="state-sync")

    def _agent_for(self, engine_id: str) -> str | None:
        for agent in self.quick_sync.manager.list_agents(sync_first=False):
            if agent.engine_id == engine_id:
                return agent.id
        return None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await asyncio.to_thread(self.quick_sync.sync_all)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # survive store blips (next tick retries) but visibly:
                # a reconciler that dies silently lets desired and actual
                # state drift until someone notices the hard way
                self.sync_errors_total += 1
                self.last_error = f"{type(e).__name__}: {e}"

    async def stop(self) -> None:
        if self._unsub:
            self._unsub()
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def sync_now(self) -> None:
        await asyncio.to_thread(self.quick_sync.sync_all)
