"""Runtime backend interface — the Docker-daemon role, accelerator-shaped.

In the reference the runtime is the Docker daemon: agents are containers the
control plane creates/starts/stops/pauses over the Docker socket
(reference internal/agent/agent.go:431-508, pkg/docker/client.go:10-28), and
the reconciler lists containers + watches the daemon event stream
(state_sync.go:253-309).

Here a Backend manages *engine processes* — model-serving programs bound to
accelerator chips (GPUs in the port). The surface is deliberately the intersection the control plane
needs, so three implementations can sit behind it:

- ``FakeBackend``     in-memory, for unit tests (the fake the reference never
                      had, SURVEY.md §4),
- ``LocalBackend``    real subprocesses serving HTTP on localhost ports
                      (runtime/local.py) — the production path.

Engine states mirror container states (running/paused/created/exited) so the
reconciler's state mapping carries over (state_sync.go:216-229).

Reference: ``agentainer_tpu/runtime/backend.py``, copied but for this
docstring.
"""

from __future__ import annotations

import threading
import time
import uuid
from abc import ABC, abstractmethod
from dataclasses import dataclass
from enum import Enum
from typing import Callable

from ..core.spec import Agent


class EngineState(str, Enum):
    CREATED = "created"
    RUNNING = "running"
    PAUSED = "paused"
    EXITED = "exited"
    # crash-loop terminal state: the restart watcher gave up after the
    # rapid-death cap — the reconciler maps it to AgentStatus.FAILED, and
    # only an explicit start/resume re-arms the respawn policy
    FAILED = "failed"


@dataclass
class EngineInfo:
    engine_id: str
    agent_id: str
    state: EngineState
    endpoint: str = ""  # http URL the proxy forwards to ("" until started)
    chips: tuple[int, ...] = ()


class Backend(ABC):
    """Lifecycle operations over engine processes."""

    @abstractmethod
    def create_engine(
        self, agent: Agent, chips: tuple[int, ...], replica_index: int = 0
    ) -> str:
        """Create (but do not start) an engine; returns engine_id.

        ``replica_index`` distinguishes fleet replicas of the same agent:
        each replica must be its OWN failure domain (own process), so
        backends that pool same-model engines must key the pool per
        replica, never collapse two replicas into one process.

        Parity: container creation with labels/hostname/limits but no start
        (reference agent.go:431-508 createContainer).
        """

    @abstractmethod
    def start_engine(self, engine_id: str) -> None: ...

    @abstractmethod
    def stop_engine(self, engine_id: str, timeout_s: float = 10.0) -> None:
        """Graceful stop with the reference's 10s deadline (agent.go:194)."""

    @abstractmethod
    def pause_engine(self, engine_id: str) -> None: ...

    @abstractmethod
    def resume_engine(self, engine_id: str) -> None: ...

    @abstractmethod
    def remove_engine(self, engine_id: str) -> None: ...

    @abstractmethod
    def engine_info(self, engine_id: str) -> EngineInfo | None:
        """None if the engine is gone — the reconciler treats that like a
        vanished container (state_sync.go:169-187)."""

    @abstractmethod
    def list_engines(self) -> list[EngineInfo]: ...

    @abstractmethod
    def logs(self, engine_id: str, tail: int = 100) -> list[str]: ...

    def stats(self, engine_id: str) -> dict | None:
        """Resource/serving counters for the metrics plane (docker
        ContainerStats analogue, collector.go:228)."""
        return None

    def probe_engine(self, engine_id: str) -> bool:
        """Liveness beyond process state: does the engine actually answer?

        A SIGKILL'd process can report running for a beat (the exit status
        isn't reapable yet) while its socket already refuses connections —
        resume() must not trust engine_info alone or it no-ops on an agent
        that is mid-crash and returns success for a dead engine. Default:
        trust engine_info (backends without an HTTP surface).
        """
        info = self.engine_info(engine_id)
        return info is not None and info.state == EngineState.RUNNING

    def subscribe_events(self, callback: Callable[[str, EngineState], None]) -> Callable[[], None]:
        """Push-based engine state changes (docker event stream analogue).

        Default: no events; reconciler falls back to periodic polling, which
        the reference also keeps as belt-and-braces (state_sync.go:232-250).
        Returns an unsubscribe function.
        """
        return lambda: None

    def close(self) -> None:
        pass


class FakeBackend(Backend):
    """In-memory backend for tests: full state machine, injectable crashes."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._engines: dict[str, EngineInfo] = {}
        self._logs: dict[str, list[str]] = {}
        self._listeners: list[Callable[[str, EngineState], None]] = []
        self.start_delay_s = 0.0

    def _emit(self, engine_id: str, state: EngineState) -> None:
        for cb in list(self._listeners):
            try:
                cb(engine_id, state)
            except Exception:
                pass

    def create_engine(
        self, agent: Agent, chips: tuple[int, ...], replica_index: int = 0
    ) -> str:
        with self._lock:
            engine_id = f"eng-{uuid.uuid4().hex[:12]}"
            self._engines[engine_id] = EngineInfo(
                engine_id=engine_id,
                agent_id=agent.id,
                state=EngineState.CREATED,
                # the engine id rides the endpoint so the proxy's fake://
                # dispatch reaches the ROUTED replica, not always the primary
                endpoint=f"fake://{agent.id}/{engine_id}",
                chips=chips,
            )
            self._logs[engine_id] = [f"created engine for {agent.id} on chips {chips}"]
            return engine_id

    def start_engine(self, engine_id: str) -> None:
        if self.start_delay_s:
            time.sleep(self.start_delay_s)
        with self._lock:
            info = self._require(engine_id)
            info.state = EngineState.RUNNING
            self._logs[engine_id].append("started")
        self._emit(engine_id, EngineState.RUNNING)

    def stop_engine(self, engine_id: str, timeout_s: float = 10.0) -> None:
        with self._lock:
            info = self._require(engine_id)
            info.state = EngineState.EXITED
            self._logs[engine_id].append("stopped")
        self._emit(engine_id, EngineState.EXITED)

    def pause_engine(self, engine_id: str) -> None:
        with self._lock:
            info = self._require(engine_id)
            if info.state != EngineState.RUNNING:
                raise RuntimeError(f"engine {engine_id} not running")
            info.state = EngineState.PAUSED
        self._emit(engine_id, EngineState.PAUSED)

    def resume_engine(self, engine_id: str) -> None:
        with self._lock:
            info = self._require(engine_id)
            if info.state != EngineState.PAUSED:
                raise RuntimeError(f"engine {engine_id} not paused")
            info.state = EngineState.RUNNING
        self._emit(engine_id, EngineState.RUNNING)

    def remove_engine(self, engine_id: str) -> None:
        with self._lock:
            self._engines.pop(engine_id, None)
            self._logs.pop(engine_id, None)

    def engine_info(self, engine_id: str) -> EngineInfo | None:
        with self._lock:
            return self._engines.get(engine_id)

    def list_engines(self) -> list[EngineInfo]:
        with self._lock:
            return list(self._engines.values())

    def logs(self, engine_id: str, tail: int = 100) -> list[str]:
        with self._lock:
            return self._logs.get(engine_id, [])[-tail:]

    def subscribe_events(self, callback: Callable[[str, EngineState], None]) -> Callable[[], None]:
        self._listeners.append(callback)

        def unsub() -> None:
            if callback in self._listeners:
                self._listeners.remove(callback)

        return unsub

    def handle_request(
        self, engine_id: str, method: str, path: str, headers: dict, body: bytes
    ) -> tuple[int, dict[str, str], bytes]:
        """In-process request dispatch for ``fake://`` endpoints.

        Raises ConnectionError when the engine is not running — the analogue
        of connection-refused against a dead container, which the proxy's
        crash heuristic keys on (reference server.go:597-606).
        """
        import json as _json

        with self._lock:
            info = self._engines.get(engine_id)
            if info is None or info.state != EngineState.RUNNING:
                raise ConnectionError(f"engine {engine_id} not running")
        route = path.split("?")[0]
        if route == "/health":
            return 200, {"Content-Type": "application/json"}, b'{"status":"healthy"}'
        payload = {
            "echo": {
                "method": method,
                "path": path,
                "body": body.decode("utf-8", "replace"),
            }
        }
        return 200, {"Content-Type": "application/json"}, _json.dumps(payload).encode()

    # -- test helpers ----------------------------------------------------
    def crash_engine(self, engine_id: str) -> None:
        """Simulate a hard crash (container OOM-kill analogue)."""
        with self._lock:
            info = self._require(engine_id)
            info.state = EngineState.EXITED
            self._logs[engine_id].append("crashed")
        self._emit(engine_id, EngineState.EXITED)

    def vanish_engine(self, engine_id: str) -> None:
        """Simulate the engine record disappearing entirely (docker rm -f)."""
        with self._lock:
            self._engines.pop(engine_id, None)

    def _require(self, engine_id: str) -> EngineInfo:
        info = self._engines.get(engine_id)
        if info is None:
            raise KeyError(f"no such engine: {engine_id}")
        return info
