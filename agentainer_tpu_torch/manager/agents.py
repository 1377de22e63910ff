"""Agent lifecycle manager.

Reference: ``agentainer_tpu/manager/agents.py``, replica fleet included
(N engine replicas per agent, their initial leases, scale-down), and the
native data plane's routing hook (``set_route_hook``: every save and
removal of an agent record, the fleet's included, feeds the C++ routing
table). Model validation
reads ``models/configs.py`` (standard library), so the daemon never
imports torch.

Re-implements the reference's ``agent.Manager`` (internal/agent/agent.go:80-429)
against the Backend/SliceScheduler pair instead of the Docker socket:

- ``deploy`` persists a record only — no engine is created
  (parity with agent.go:104-142: Deploy creates no container);
- ``start`` allocates chips, creates-or-starts the engine (agent.go:144-181);
- ``stop`` graceful 10s (agent.go:183-215); ``restart`` = stop+start
  (agent.go:217-222);
- ``pause``/``resume`` map to engine pause/unpause, and **resume also
  rehydrates**: a stopped/failed agent gets its engine restarted, a vanished
  engine is re-created purely from the saved record (agent.go:255-311);
- ``remove`` tears down the engine, releases chips, and deletes every store
  key for the agent including its request queues (agent.go:313-370);
- every mutation fires an async quick-sync, and ``list`` quick-syncs
  synchronously first so listings are never stale (agent.go:174-178,393-398).

Status changes publish on ``agent:status:{id}`` — the control-plane event bus
that health/metrics subscribe to (state_sync.go:311-317).
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Any

from ..core.errors import AgentNotFound, InvalidInput, InvalidTransition
from ..core.spec import Agent, AgentStatus, HealthCheckConfig, ModelRef, Resources, new_agent_id
from ..runtime.backend import Backend, EngineState
from ..runtime.scheduler import SliceScheduler
from ..store.base import Store
from ..store.schema import Keys


class AgentManager:
    def __init__(self, store: Store, backend: Backend, scheduler: SliceScheduler):
        self.store = store
        self.backend = backend
        self.scheduler = scheduler
        self._lock = threading.RLock()
        self._quick_sync = None  # wired by the daemon to avoid an import cycle
        self._route_hook = None  # native data plane routing-table feed
        # fleet defaults (config fleet.*, set by build_services): how many
        # engine replicas a start spawns when the agent record doesn't pin
        # its own count, and the TTL of the initial replica lease
        self.fleet_replicas = 1
        self.lease_ttl_s = 6.0
        # fleet bookkeeping failures are best-effort but never silent
        self.lease_register_errors_total = 0
        self.replica_scaledown_errors_total = 0

    def set_fleet(self, replicas: int, lease_ttl_s: float) -> None:
        self.fleet_replicas = max(1, int(replicas))
        self.lease_ttl_s = float(lease_ttl_s)

    def replica_count(self, agent: Agent) -> int:
        """Desired replicas for this agent: the record's own pin wins,
        else the fleet default."""
        return max(1, int(agent.replicas or self.fleet_replicas))

    def set_quick_sync(self, quick_sync) -> None:
        self._quick_sync = quick_sync

    def set_route_hook(self, hook) -> None:
        """``hook(agent | None, agent_id)`` — called after every persisted
        mutation (agent=None means removed) so the native data plane's routing
        table tracks the store. Existing agents are pushed immediately."""
        self._route_hook = hook
        for agent in self.list_agents(sync_first=False):
            hook(agent, agent.id)

    def _fire_route_hook(self, agent: Agent | None, agent_id: str) -> None:
        if self._route_hook is not None:
            try:
                self._route_hook(agent, agent_id)
            except Exception:
                pass  # routing must never break a lifecycle op

    def _fire_quick_sync(self, agent_id: str) -> None:
        if self._quick_sync is not None:
            # async-after-mutation, parity with `go quickSync.SyncAgent(...)`
            # (agent.go:174-178); daemon thread so tests exit cleanly.
            threading.Thread(
                target=self._quick_sync.sync_agent, args=(agent_id,), daemon=True
            ).start()

    # -- persistence (agent.go:510-592) ---------------------------------
    def save_agent(self, agent: Agent, publish_status: bool = False) -> None:
        agent.updated_at = time.time()
        self.store.set_json(Keys.agent(agent.id), agent.to_dict())
        self.store.sadd(Keys.AGENTS_LIST, agent.id)
        # legacy status key kept for parity (state_sync.go:203-206)
        self.store.set(Keys.agent_status(agent.id), agent.status.value)
        if publish_status:
            self.store.publish(Keys.status_channel(agent.id), agent.status.value)
        self._fire_route_hook(agent, agent.id)

    def get_agent(self, agent_id: str) -> Agent:
        raw = self.store.get_json(Keys.agent(agent_id))
        if raw is None:
            raise AgentNotFound(agent_id)
        return Agent.from_dict(raw)

    def list_agents(self, sync_first: bool = True) -> list[Agent]:
        if sync_first and self._quick_sync is not None:
            # synchronous sync-before-list so CLI `list` is never stale
            # (agent.go:393-398)
            self._quick_sync.sync_all()
        agents = []
        for agent_id in sorted(self.store.smembers(Keys.AGENTS_LIST)):
            raw = self.store.get_json(Keys.agent(agent_id))
            if raw is not None:
                agents.append(Agent.from_dict(raw))
        return agents

    def _set_status(self, agent: Agent, status: AgentStatus) -> None:
        agent.status = status
        self.save_agent(agent, publish_status=True)

    # -- lifecycle -------------------------------------------------------
    def deploy(
        self,
        name: str,
        model: ModelRef | str | dict,
        env: dict[str, str] | None = None,
        resources: Resources | None = None,
        auto_restart: bool = False,
        token: str = "",
        health_check: HealthCheckConfig | None = None,
        replicas: int = 0,
    ) -> Agent:
        if not name or len(name) > 64:
            # input validation parity: name required, ≤64 chars (server.go:157-179)
            raise InvalidInput("agent name must be 1-64 characters")
        if replicas < 0 or replicas > 64:
            raise InvalidInput("replicas must be 0 (fleet default) to 64")
        ref = model if isinstance(model, ModelRef) else ModelRef.from_dict(model)
        self._validate_model(ref)
        agent = Agent(
            id=new_agent_id(),
            name=name,
            model=ref,
            env=dict(env or {}),
            resources=resources or Resources(),
            auto_restart=auto_restart,
            token=token,
            health_check=health_check,
            replicas=int(replicas),
        )
        with self._lock:
            self.save_agent(agent)
        return agent

    def _validate_model(self, ref: ModelRef) -> None:
        """Image-exists validation parity (agent.go:106 ImageInspectWithRaw)."""
        from ..engine import is_gpu_engine, known_engines

        if ref.engine not in known_engines():
            raise InvalidInput(f"unknown engine {ref.engine!r}; known: {sorted(known_engines())}")
        if is_gpu_engine(ref.engine):
            if not ref.config and ref.checkpoint:
                # HF checkpoints carry their own config.json; the engine
                # derives the model config from the checkpoint itself
                # (LLMEngine.create → config_from_hf), so "checkpoint only"
                # is a valid deploy — the artifact flow depends on it
                ckpt = Path(ref.checkpoint).expanduser()
                if ckpt.is_dir() and any(ckpt.glob("*.safetensors")):
                    return
                raise InvalidInput(
                    f"checkpoint {ref.checkpoint!r} has no model config: name "
                    f"one explicitly (model.config) or point at an HF layout"
                )
            from ..models.configs import get_config

            try:
                get_config(ref.config)
            except KeyError as e:
                raise InvalidInput(str(e)) from None

    def start(self, agent_id: str) -> Agent:
        with self._lock:
            agent = self.get_agent(agent_id)
            if agent.status == AgentStatus.RUNNING:
                info = agent.engine_id and self.backend.engine_info(agent.engine_id)
                if info and info.state == EngineState.RUNNING:
                    return agent  # idempotent
            if not can_start(agent.status):
                raise InvalidTransition(agent_id, agent.status.value, "start")
            self._start_engine(agent)
            self._set_status(agent, AgentStatus.RUNNING)
        self._fire_quick_sync(agent_id)
        return agent

    def _start_engine(self, agent: Agent) -> None:
        """Create-or-start every replica, parity with agent.go:154-164: an
        engine record that still exists is started again, else one is
        created on the agent's placement (allocated on first start).

        The single-replica path is one engine with ``replica_ids`` empty.
        With N > 1 each replica is created with its own ordinal (its own
        process and failure domain in the backend) over the agent's one
        placement, and a fresh lease is registered so the replica monitor starts from an
        ALIVE view instead of a cold SUSPECT window."""
        n = self.replica_count(agent)
        live = [
            eid for eid in agent.all_engine_ids() if self.backend.engine_info(eid)
        ]
        if len(live) < n:
            from ..engine import is_gpu_engine

            # model-backed flavors sharing a model config share weight memory
            share_group = agent.model.config if is_gpu_engine(agent.model.engine) else ""
            placement = self.scheduler.placement(agent.id) or self.scheduler.allocate(
                agent, share_group=share_group
            )
            for i in range(len(live), n):
                live.append(
                    self.backend.create_engine(
                        agent, placement.chips, replica_index=i
                    )
                )
        # scale-down (operator lowered the count): surplus replicas stop
        for eid in live[n:]:
            try:
                self.backend.stop_engine(eid, timeout_s=5.0)
                self.backend.remove_engine(eid)
            except Exception as e:
                # a stuck surplus replica must not block the start; counted
                # so a leak is visible, and the reconciler's orphan sweep
                # remains the net
                self.replica_scaledown_errors_total += 1
                print(
                    f"[manager] scale-down of replica {eid} failed: {e!r}",
                    flush=True,
                )
        live = live[:n]
        agent.engine_id = live[0]
        agent.replica_ids = list(live) if n > 1 else []
        for eid in live:
            self.backend.start_engine(eid)
        if n > 1:
            self._register_leases(agent)

    def _register_leases(self, agent: Agent) -> None:
        """Initial heartbeat leases for a multi-replica agent (refreshed by
        the replica monitor). Best-effort: a store blip here must not fail
        the start — the monitor writes the same keys on its next tick."""
        import time as _time

        for eid in agent.all_engine_ids():
            try:
                self.store.set_json(
                    Keys.replica_lease(agent.id, eid),
                    {"engine_id": eid, "agent_id": agent.id, "at": _time.time()},
                    ttl=self.lease_ttl_s,
                )
            except Exception:
                self.lease_register_errors_total += 1

    def stop(self, agent_id: str, timeout_s: float = 10.0) -> Agent:
        with self._lock:
            agent = self.get_agent(agent_id)
            if agent.status not in (AgentStatus.RUNNING, AgentStatus.PAUSED):
                raise InvalidTransition(agent_id, agent.status.value, "stop")
            for eid in agent.all_engine_ids():
                if self.backend.engine_info(eid):
                    self.backend.stop_engine(eid, timeout_s=timeout_s)
            self._set_status(agent, AgentStatus.STOPPED)
        self._fire_quick_sync(agent_id)
        return agent

    def restart(self, agent_id: str) -> Agent:
        agent = self.get_agent(agent_id)
        if agent.status in (AgentStatus.RUNNING, AgentStatus.PAUSED):
            self.stop(agent_id)
        return self.start(agent_id)

    def pause(self, agent_id: str) -> Agent:
        with self._lock:
            agent = self.get_agent(agent_id)
            if agent.status != AgentStatus.RUNNING:
                raise InvalidTransition(agent_id, agent.status.value, "pause")
            for eid in agent.all_engine_ids():
                self.backend.pause_engine(eid)
            self._set_status(agent, AgentStatus.PAUSED)
        self._fire_quick_sync(agent_id)
        return agent

    def resume(self, agent_id: str) -> Agent:
        """Pause-undo *and* rehydration (agent.go:255-311): paused → unpause;
        stopped/failed/created → restart or fully re-create the engine from
        the saved record."""
        with self._lock:
            agent = self.get_agent(agent_id)
            if agent.status == AgentStatus.PAUSED:
                for eid in agent.all_engine_ids():
                    self.backend.resume_engine(eid)
            elif agent.status in (AgentStatus.STOPPED, AgentStatus.FAILED, AgentStatus.CREATED):
                self._start_engine(agent)
            elif agent.status == AgentStatus.RUNNING:
                # probe too: a just-SIGKILL'd process reports running for a
                # beat (exit not reapable yet) while its socket already
                # refuses — trusting engine_info alone would no-op resume on
                # a mid-crash agent and return success for a dead engine.
                # Fleet: ANY dead replica triggers repair (_start_engine
                # reuses live replicas and recreates only the missing ones).
                def _dead(eid: str) -> bool:
                    info = self.backend.engine_info(eid)
                    return (
                        not info
                        or info.state != EngineState.RUNNING
                        or not self.backend.probe_engine(eid)
                    )

                ids = agent.all_engine_ids()
                if not ids or any(_dead(eid) for eid in ids):
                    self._start_engine(agent)  # crashed-but-not-yet-reconciled
                else:
                    return agent
            self._set_status(agent, AgentStatus.RUNNING)
        self._fire_quick_sync(agent_id)
        return agent

    def remove(self, agent_id: str) -> None:
        """Teardown + key cleanup including request queues (agent.go:313-370)."""
        with self._lock:
            agent = self.get_agent(agent_id)
            for eid in agent.all_engine_ids():
                if self.backend.engine_info(eid):
                    try:
                        self.backend.stop_engine(eid, timeout_s=5.0)
                    except Exception:
                        pass
                    self.backend.remove_engine(eid)
            self.scheduler.release(agent_id)
            self.store.srem(Keys.AGENTS_LIST, agent_id)
            doomed = [
                Keys.internal_token(agent_id),
                Keys.agent(agent_id),
                Keys.agent_status(agent_id),
                Keys.pending(agent_id),
                Keys.completed(agent_id),
                Keys.failed(agent_id),
                Keys.health(agent_id),
                Keys.metrics_current(agent_id),
                Keys.metrics_history(agent_id),
                Keys.conversations(agent_id),
                Keys.agent_metrics_hash(agent_id),
            ]
            doomed += self.store.keys(f"agent:{agent_id}:requests:*")
            doomed += self.store.keys(Keys.conversations_pattern(agent_id))
            doomed += self.store.keys(Keys.kvcache_pattern(agent_id))
            doomed += self.store.keys(Keys.replica_lease_pattern(agent_id))
            self.store.delete(*doomed)
        self._fire_route_hook(None, agent_id)

    def logs(self, agent_id: str, tail: int = 100) -> list[str]:
        agent = self.get_agent(agent_id)
        if not agent.engine_id:
            return []
        return self.backend.logs(agent.engine_id, tail=tail)

    def log_path(self, agent_id: str) -> str | None:
        agent = self.get_agent(agent_id)
        if not agent.engine_id:
            return None
        fn = getattr(self.backend, "log_path", None)
        return fn(agent.engine_id) if fn else None

    # -- helpers for services -------------------------------------------
    def try_get(self, agent_id: str) -> Agent | None:
        try:
            return self.get_agent(agent_id)
        except AgentNotFound:
            return None

    def agent_ids(self) -> set[str]:
        return self.store.smembers(Keys.AGENTS_LIST)

    def endpoint(self, agent: Agent) -> str | None:
        if not agent.engine_id:
            return None
        info = self.backend.engine_info(agent.engine_id)
        return info.endpoint if info else None

    def replica_endpoints(self, agent: Agent) -> list[tuple[str, str]]:
        """(engine_id, endpoint) for every replica whose engine record still
        exists — the routing tier's candidate set. Order is stable (primary
        first) so single-replica behavior degenerates to ``endpoint``."""
        out = []
        for eid in agent.all_engine_ids():
            info = self.backend.engine_info(eid)
            if info is not None and info.endpoint:
                out.append((eid, info.endpoint))
        return out

    def summary(self, agent: Agent) -> dict[str, Any]:
        placement = self.scheduler.placement(agent.id)
        d = agent.to_dict()
        d["placement"] = placement.to_dict() if placement else None
        return d


def can_start(status: AgentStatus) -> bool:
    return status in (
        AgentStatus.CREATED,
        AgentStatus.STOPPED,
        AgentStatus.FAILED,
        AgentStatus.RUNNING,  # idempotent start when engine crashed
    )
