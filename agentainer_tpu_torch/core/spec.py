"""Core agent data model.

Mirrors the reference ``Agent`` struct and status machine
(reference internal/agent/agent.go:21-78) with accelerator resource semantics:

- ``image`` (a Docker image ref) becomes ``model``: which engine to run
  (mock echo / the LLM engine) and which model config + checkpoint it serves;
- ``container_id`` becomes ``engine_id``: the runtime handle of the serving
  process placed on chips (GPUs in the port);
- ``cpu_limit``/``memory_limit`` (NanoCPUs/bytes, agent.go:49-50) become
  ``resources``: number of chips and a device-memory budget in bytes — the units
  the slice scheduler actually allocates.

Everything is JSON-serializable; the JSON record stored at ``agent:{id}``
is the durable source of truth that rehydration re-creates engines from
(the analogue of reference Resume re-creating a container purely from the
saved record, agent.go:271-294).

Reference: ``agentainer_tpu/core/spec.py``, copied but for this docstring.
In the port a "chip" is one GPU and ``hbm_bytes`` is card memory.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from enum import Enum
from typing import Any


class AgentStatus(str, Enum):
    """Reference status enum, agent.go:21-29 (created/running/stopped/paused/failed)."""

    CREATED = "created"
    RUNNING = "running"
    STOPPED = "stopped"
    PAUSED = "paused"
    FAILED = "failed"


# Legal transitions enforced by the lifecycle manager. The reference enforces
# these ad hoc (e.g. Stop refuses non-running agents, agent.go:189-191;
# Pause requires running, agent.go:226-231; Resume rehydrates stopped/failed/
# created, agent.go:255-311).
_TRANSITIONS: dict[AgentStatus, set[AgentStatus]] = {
    AgentStatus.CREATED: {AgentStatus.RUNNING, AgentStatus.FAILED},
    AgentStatus.RUNNING: {
        AgentStatus.STOPPED,
        AgentStatus.PAUSED,
        AgentStatus.FAILED,
        AgentStatus.RUNNING,
    },
    AgentStatus.STOPPED: {AgentStatus.RUNNING, AgentStatus.FAILED},
    AgentStatus.PAUSED: {AgentStatus.RUNNING, AgentStatus.STOPPED, AgentStatus.FAILED},
    AgentStatus.FAILED: {AgentStatus.RUNNING, AgentStatus.STOPPED},
}


def can_transition(src: AgentStatus, dst: AgentStatus) -> bool:
    return dst in _TRANSITIONS[src]


@dataclass
class HealthCheckConfig:
    """Reference CheckConfig defaults: /health, 30s interval, 5s timeout,
    3 retries (monitor.go:117-129)."""

    endpoint: str = "/health"
    interval_s: float = 30.0
    timeout_s: float = 5.0
    retries: int = 3

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "HealthCheckConfig | None":
        if d is None:
            return None
        return HealthCheckConfig(
            endpoint=d.get("endpoint", "/health"),
            interval_s=float(d.get("interval_s", 30.0)),
            timeout_s=float(d.get("timeout_s", 5.0)),
            retries=int(d.get("retries", 3)),
        )


@dataclass
class Resources:
    """Resource request: chips + device-memory (HBM) budget.

    Replaces the reference's NanoCPU / memory-bytes limits (agent.go:49-50,
    deployment.go:251-337). ``hbm_bytes`` bounds weights+KV for this agent so
    multiple agents can share a slice without eviction storms.
    """

    chips: int = 1
    hbm_bytes: int = 8 * 1024**3

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any] | None) -> "Resources":
        if d is None:
            return Resources()
        return Resources(chips=int(d.get("chips", 1)), hbm_bytes=int(d.get("hbm_bytes", 8 * 1024**3)))


@dataclass
class ModelRef:
    """What the agent serves — replaces the Docker image reference.

    ``engine`` selects the serving program ("echo" for the mock-LLM parity
    agent, "llm" for the JAX prefill+decode engine); ``config`` names a model
    config from models/configs.py; ``checkpoint`` optionally points at a
    weight snapshot (absent → randomly initialized, which is what CI uses).
    """

    engine: str = "echo"
    config: str = ""
    checkpoint: str = ""
    options: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any] | str | None) -> "ModelRef":
        if d is None:
            return ModelRef()
        if isinstance(d, str):  # shorthand: "echo" or "llm:llama3-8b"
            engine, _, config = d.partition(":")
            return ModelRef(engine=engine or "echo", config=config)
        return ModelRef(
            engine=d.get("engine", "echo"),
            config=d.get("config", ""),
            checkpoint=d.get("checkpoint", ""),
            options=dict(d.get("options", {})),
        )


@dataclass
class Agent:
    """The durable agent record (reference Agent struct, agent.go:43-59)."""

    id: str
    name: str
    model: ModelRef
    status: AgentStatus = AgentStatus.CREATED
    engine_id: str = ""
    # replica fleet: every engine serving this agent, primary first.
    # ``engine_id`` stays the primary replica's id (replica_ids[0]) so
    # every pre-fleet reader keeps working; single-replica agents may
    # leave this empty (engine_id alone is authoritative then).
    replica_ids: list[str] = field(default_factory=list)
    # engine replicas for this agent: 0 = use the fleet default
    # (config fleet.replicas); >= 1 pins this agent explicitly
    replicas: int = 0
    env: dict[str, str] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    auto_restart: bool = False
    token: str = ""
    health_check: HealthCheckConfig | None = None
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "name": self.name,
            "model": self.model.to_dict(),
            "status": self.status.value,
            "engine_id": self.engine_id,
            "replica_ids": list(self.replica_ids),
            "replicas": self.replicas,
            "env": dict(self.env),
            "resources": self.resources.to_dict(),
            "auto_restart": self.auto_restart,
            "token": self.token,
            "health_check": self.health_check.to_dict() if self.health_check else None,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Agent":
        return Agent(
            id=d["id"],
            name=d["name"],
            model=ModelRef.from_dict(d.get("model")),
            status=AgentStatus(d.get("status", "created")),
            engine_id=d.get("engine_id", ""),
            replica_ids=list(d.get("replica_ids", []) or []),
            replicas=int(d.get("replicas", 0) or 0),
            env=dict(d.get("env", {})),
            resources=Resources.from_dict(d.get("resources")),
            auto_restart=bool(d.get("auto_restart", False)),
            token=d.get("token", ""),
            health_check=HealthCheckConfig.from_dict(d.get("health_check")),
            created_at=float(d.get("created_at", 0.0)),
            updated_at=float(d.get("updated_at", 0.0)),
        )

    def all_engine_ids(self) -> list[str]:
        """Every engine serving this agent, primary first. Single-replica
        records predate ``replica_ids``, so fall back to ``engine_id``."""
        if self.replica_ids:
            return list(self.replica_ids)
        return [self.engine_id] if self.engine_id else []


def new_agent_id() -> str:
    """ID scheme parity: ``agent-{unix-nanos}`` (reference agent.go:594-596)."""
    return f"agent-{time.time_ns()}"
