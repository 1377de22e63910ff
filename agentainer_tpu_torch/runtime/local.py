"""Local process backend — real engine processes on the machine.

Reference: ``agentainer_tpu/runtime/local.py`` — the production stand-in for
the reference's Docker daemon: each agent engine runs as an OS process
serving HTTP on a localhost port, with

- graceful stop: SIGTERM then SIGKILL after the reference's 10 s deadline;
- pause/resume via SIGSTOP/SIGCONT (docker pause/unpause);
- the restart watcher: with auto-restart, an engine that exits unexpectedly
  is respawned, with the crash-loop backoff (a first death respawns on the
  next 200 ms tick, consecutive rapid deaths back off exponentially, and
  past ``restart_max_rapid`` of them the agent lands FAILED with a reason);
- engine events pushed to the reconciler when the watcher sees a change;
- stdout/stderr captured to per-engine log files (``GetLogs`` parity);
- the shared llm host: ``llm``/``assistant`` agents with the same model,
  weights, options and GPUs are tenants of ONE host process (one weight
  copy on the card), attached through the host's ``/-/tenants``.

GPU pinning: an engine sees only the GPUs of its placement through
``CUDA_VISIBLE_DEVICES`` (where the reference carves its slice for JAX), and
every other engine is spawned with ``CUDA_VISIBLE_DEVICES=""`` (the
reference's ``JAX_PLATFORMS=cpu``), so it cannot create a CUDA context.
``AGENTAINER_CHIPS`` keeps the placement's GPU ids; the engine resolves a
single id that is not visible to its one visible device
(``engine/llm.py::_engine_device``). An llm engine whose model cannot
load exits with ``LOAD_FAILED_EXIT``, and the watcher lands the agent
FAILED at once with the error line of its log (the crash-loop policy's
terminal state); it never comes back on another device. A host respawned
for one tenant holds none of its co-tenants: they read as exited until
they attach again. ``ready_timeout_s`` (180 s)
covers an engine process's start up to its first ``/health`` answer; the
model loads behind it and reports ready to ``/internal/engines/ready``.
The reference's warm-boot marker, compile cache and native store socket
have no counterpart here.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from .. import faults
from ..core.spec import Agent
from ..store.base import Store
from .backend import Backend, EngineInfo, EngineState


ENGINE_MAIN = "agentainer_tpu_torch.runtime.engine_main"
# an llm engine under a control plane exits with this code when its model
# cannot load (engine/llm_serve.py): the watcher lands the agent FAILED
LOAD_FAILED_EXIT = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# serve-level knobs that do not change the loaded model: they must not
# fragment the weight-sharing key (two personas over one checkpoint share)
_PERSONA_OPTS = (
    "system_prompt",
    "flatten_history",
    "history_turns",
    "kv_snapshot_interval_s",
)


@dataclass
class _EngineRec:
    engine_id: str
    agent_id: str
    port: int
    cmd: list[str]
    env: dict[str, str]
    chips: tuple[int, ...]
    auto_restart: bool
    log_path: Path
    proc: subprocess.Popen | None = None
    paused: bool = False
    desired_running: bool = False
    restarts: int = 0
    log_file: object = None
    # multi-tenant model host (llm_serve engines): this rec is a TENANT of
    # the shared host process keyed by share_key; proc stays None
    share_key: tuple | None = None
    attached: bool = False
    # a co-tenant respawned the host: this tenant is not in the new one
    host_lost: bool = False
    # crash-loop accounting (restart watcher): when the current incarnation
    # was spawned, how many consecutive deaths happened within the rapid
    # window, when the next respawn is allowed, and whether the watcher gave
    # up (terminal FAILED until an explicit start/resume re-arms it)
    last_spawn_at: float = 0.0
    rapid_deaths: int = 0
    respawn_pending: bool = False
    next_respawn_at: float = 0.0
    gave_up: bool = False
    failed_reason: str = ""
    respawn_attempts: list = field(default_factory=list)


@dataclass
class _HostRec:
    """One multi-tenant engine process: one model load, N agents attached.

    Separate per-agent processes would each load their own weight copy; a
    host process holds ONE parameter tree on its GPUs and serves every
    same-(model, weights, options, GPUs) agent from it.
    """

    key: tuple
    port: int
    admin_token: str
    env: dict[str, str]
    log_path: Path
    proc: subprocess.Popen | None = None
    log_file: object = None


class LocalBackend(Backend):
    def __init__(
        self,
        store: Store | None = None,
        data_dir: str | Path | None = None,
        python: str = sys.executable,
        ready_timeout_s: float = 180.0,
        restart_backoff_base_s: float | None = None,
        restart_backoff_max_s: float | None = None,
        restart_window_s: float | None = None,
        restart_max_rapid: int | None = None,
    ):
        self.store = store
        self.python = python
        self.ready_timeout_s = ready_timeout_s

        # crash-loop policy (config resilience.* via build_services; env for
        # backends constructed directly, e.g. tests and bench harnesses)
        def _envf(name: str, default: float) -> float:
            try:
                return float(os.environ.get(name, default))
            except ValueError:
                return default

        self.restart_backoff_base_s = (
            restart_backoff_base_s
            if restart_backoff_base_s is not None
            else _envf("ATPU_RESTART_BACKOFF_BASE_S", 0.5)
        )
        self.restart_backoff_max_s = (
            restart_backoff_max_s
            if restart_backoff_max_s is not None
            else _envf("ATPU_RESTART_BACKOFF_MAX_S", 30.0)
        )
        self.restart_window_s = (
            restart_window_s
            if restart_window_s is not None
            else _envf("ATPU_RESTART_WINDOW_S", 30.0)
        )
        self.restart_max_rapid = int(
            restart_max_rapid
            if restart_max_rapid is not None
            else _envf("ATPU_RESTART_MAX_RAPID", 5)
        )
        self.control_url = ""
        self.internal_token = ""
        self._dir = Path(data_dir or tempfile.mkdtemp(prefix="atpu-engines-")).expanduser()
        (self._dir / "engines").mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()
        self._recs: dict[str, _EngineRec] = {}
        self._hosts: dict[tuple, _HostRec] = {}
        # host CPU accounting deltas: engine_id -> (t, jiffies, pid)
        self._cpu_last: dict[str, tuple[float, int, int]] = {}
        self._listeners: list[Callable[[str, EngineState], None]] = []
        self._watcher = threading.Thread(target=self._watch_loop, daemon=True)
        self._closed = False
        self._watcher.start()

    def set_control(self, url: str, token: str = "") -> None:
        """Tell engines where the control plane (and its store API) lives.

        ``token`` is accepted for backward compatibility but unused: engines
        authenticate with per-engine tokens minted at create_engine, never
        the admin bearer token.
        """
        self.control_url = url

    # -- backend interface ----------------------------------------------
    def create_engine(
        self, agent: Agent, chips: tuple[int, ...], replica_index: int = 0
    ) -> str:
        engine_id = f"eng-{uuid.uuid4().hex[:12]}"
        port = _free_port()
        # Per-agent store credential: engines never see the admin token, and
        # the control plane validates this one against internal:token:{id}
        # (outside the namespace engines can reach). The token is an
        # AGENT-scoped capability, so fleet replicas REUSE an existing one —
        # a second replica minting its own would overwrite the key and 401
        # the first replica's snapshot/conversation writes mid-flight.
        engine_token = uuid.uuid4().hex + uuid.uuid4().hex
        if self.store is not None:
            from ..store.schema import Keys

            existing = self.store.get(Keys.internal_token(agent.id))
            if existing:
                engine_token = (
                    existing.decode() if isinstance(existing, bytes) else str(existing)
                )
            else:
                self.store.set(Keys.internal_token(agent.id), engine_token)
        env = dict(os.environ)
        env.update(agent.env)
        env.update(
            {
                "AGENTAINER_AGENT_ID": agent.id,
                "AGENTAINER_AGENT_NAME": agent.name,
                "AGENTAINER_ENGINE": agent.model.engine,
                "AGENTAINER_MODEL_CONFIG": agent.model.config,
                "AGENTAINER_CHECKPOINT": agent.model.checkpoint,
                # engine tuning knobs (quant/max_batch/max_seq/…) ride the
                # same env channel the reference uses for container config
                "AGENTAINER_MODEL_OPTIONS": json.dumps(agent.model.options or {}),
                "AGENTAINER_PORT": str(port),
                # fleet replica ordinal: engines surface it in /metrics so
                # operators can attribute traffic/restarts to one replica
                "AGENTAINER_REPLICA": str(replica_index),
                "AGENTAINER_CHIPS": ",".join(map(str, chips)),
                "AGENTAINER_CONTROL_URL": self.control_url,
                "AGENTAINER_INTERNAL_TOKEN": engine_token,
                # torch.profiler traces land here (POST /agents/{id}/profile)
                "AGENTAINER_PROFILE_DIR": str(self._dir / "profiles" / agent.id),
            }
        )
        from ..engine import LLM_SERVE, engine_registry, is_gpu_engine

        # the placement's GPUs for a model engine, none for the rest
        gpu = is_gpu_engine(agent.model.engine)
        env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, chips)) if gpu else ""
        cmd = [self.python, "-m", ENGINE_MAIN]
        rec = _EngineRec(
            engine_id=engine_id,
            agent_id=agent.id,
            port=port,
            cmd=cmd,
            env=env,
            chips=chips,
            auto_restart=agent.auto_restart,
            log_path=self._dir / "engines" / f"{engine_id}.log",
        )
        if engine_registry().get(agent.model.engine) == LLM_SERVE:
            # llm engines become TENANTS of a shared model-host process:
            # same (model, weights, engine knobs, chips) → same host, one
            # weight copy in HBM. Persona knobs are serve-level and ride
            # the attach call, so they don't fragment the share key.
            opts = dict(agent.model.options or {})
            for k in _PERSONA_OPTS:
                opts.pop(k, None)
            # replica_index is part of the share key: a fleet replica must
            # be its OWN failure domain. Two AGENTS sharing a model still
            # share one host per replica ordinal, but two REPLICAS of one
            # agent never collapse into the same process — killing one
            # must leave the other serving.
            rec.share_key = (
                agent.model.config,
                agent.model.checkpoint,
                json.dumps(opts, sort_keys=True),
                chips,
                replica_index,
            )
            rec.log_path = self._dir / "engines" / f"host-{self._host_slug(rec.share_key)}.log"
        with self._lock:
            self._recs[engine_id] = rec
        return engine_id

    def start_engine(self, engine_id: str) -> None:
        with self._lock:
            rec = self._require(engine_id)
            # explicit start/resume re-arms the crash-loop policy: the
            # operator asked for another life, so the rapid-death latch and
            # any pending backoff are cleared
            rec.gave_up = False
            rec.failed_reason = ""
            rec.rapid_deaths = 0
            rec.respawn_pending = False
            rec.next_respawn_at = 0.0
            if rec.share_key is not None:
                rec.desired_running = True
            elif rec.proc is not None and rec.proc.poll() is None:
                rec.desired_running = True
                if self._probe(rec.port):
                    return  # genuinely alive and answering
                # poll() lies for a beat after a SIGKILL (exit status not
                # reapable yet) while the port already refuses: give the
                # kernel a moment to settle, then respawn if it's dead
                deadline = time.time() + 3.0
                while time.time() < deadline and rec.proc.poll() is None:
                    time.sleep(0.05)
                if rec.proc.poll() is None:
                    return  # alive but unresponsive: not ours to double-spawn
                self._spawn(rec)
            else:
                self._spawn(rec)
                rec.desired_running = True
        if rec.share_key is not None:
            self._ensure_host_and_attach(rec)
        else:
            self._wait_ready(rec)
        self._emit(engine_id, EngineState.RUNNING)

    # -- multi-tenant model hosts -----------------------------------------
    @staticmethod
    def _host_slug(key: tuple) -> str:
        import hashlib

        return hashlib.sha1(repr(key).encode()).hexdigest()[:12]

    def _ensure_host_and_attach(self, rec: _EngineRec) -> None:
        """Make the share-key's host process live, then attach this agent as
        a tenant (its own port + identity over the shared engine)."""
        with self._lock:
            host = self._hosts.get(rec.share_key)
            if host is None or host.proc is None or host.proc.poll() is not None:
                # a new host process holds none of the old one's tenants:
                # each co-tenant reads as not running until it attaches
                # again (the reference left them "attached" to the dead
                # host's ports, so they read as running and refused)
                for other in self._recs.values():
                    if other.share_key == rec.share_key and other is not rec and other.attached:
                        other.attached = False
                        other.host_lost = True
                host = self._spawn_host(rec)
        self._wait_host(host)
        port = self._attach_tenant(host, rec)
        with self._lock:
            rec.port = port
            rec.attached = True
            rec.host_lost = False
            rec.paused = False
            rec.last_spawn_at = time.monotonic()

    def _spawn_host(self, rec: _EngineRec) -> _HostRec:
        """Build + spawn the shared engine process from a tenant's env (the
        model-level settings are identical across the share key by
        construction; identity goes per-tenant at attach time)."""
        host = self._hosts.get(rec.share_key)
        if host is None:
            env = dict(rec.env)
            for k in (
                "AGENTAINER_AGENT_ID",
                "AGENTAINER_AGENT_NAME",
                "AGENTAINER_INTERNAL_TOKEN",
                "AGENTAINER_SYSTEM_PROMPT",
            ):
                env.pop(k, None)
            slug = self._host_slug(rec.share_key)
            env.update(
                {
                    "AGENTAINER_AGENT_ID": f"_host-{slug}",
                    "AGENTAINER_AGENT_NAME": f"model-host-{slug}",
                    "AGENTAINER_MULTI_TENANT": "1",
                    "AGENTAINER_HOST_TOKEN": uuid.uuid4().hex + uuid.uuid4().hex,
                    "AGENTAINER_PROFILE_DIR": str(self._dir / "profiles" / f"host-{slug}"),
                }
            )
            host = _HostRec(
                key=rec.share_key,
                port=0,
                admin_token=env["AGENTAINER_HOST_TOKEN"],
                env=env,
                log_path=self._dir / "engines" / f"host-{slug}.log",
            )
            self._hosts[rec.share_key] = host
        # fresh port on EVERY (re)spawn: a dead host's old port may have
        # been claimed by anyone in the meantime
        host.port = _free_port()
        host.env["AGENTAINER_PORT"] = str(host.port)
        if host.log_file is not None:
            try:
                host.log_file.close()
            except OSError:
                pass
        host.log_file = open(host.log_path, "ab")
        host.env["AGENTAINER_CONTROL_URL"] = self.control_url
        host.proc = subprocess.Popen(
            [self.python, "-m", ENGINE_MAIN],
            env=host.env,
            stdout=host.log_file,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        return host

    def _wait_host(self, host: _HostRec) -> None:
        self._wait_port(host.proc, host.port, host.log_path, f"model host {host.key[0]!r}")

    def _host_request(
        self, host: _HostRec, method: str, path: str, body: dict | None = None
    ) -> tuple[int, dict]:
        import http.client
        import json as _json

        conn = http.client.HTTPConnection("127.0.0.1", host.port, timeout=30.0)
        payload = _json.dumps(body or {}).encode()
        conn.request(
            method,
            path,
            body=payload,
            headers={
                "Authorization": f"Bearer {host.admin_token}",
                "Content-Type": "application/json",
            },
        )
        resp = conn.getresponse()
        raw = resp.read()
        conn.close()
        try:
            doc = _json.loads(raw) if raw else {}
        except _json.JSONDecodeError:
            doc = {"error": raw[:200].decode("utf-8", "replace")}
        return resp.status, doc

    def _attach_tenant(self, host: _HostRec, rec: _EngineRec) -> int:
        status, doc = self._host_request(
            host,
            "POST",
            "/-/tenants",
            {
                "agent_id": rec.agent_id,
                "name": rec.env.get("AGENTAINER_AGENT_NAME", rec.agent_id),
                "flavor": rec.env.get("AGENTAINER_ENGINE", "llm"),
                "options": json.loads(rec.env.get("AGENTAINER_MODEL_OPTIONS", "{}") or "{}"),
                "system_prompt": rec.env.get("AGENTAINER_SYSTEM_PROMPT", ""),
                "token": rec.env.get("AGENTAINER_INTERNAL_TOKEN", ""),
            },
        )
        if status != 200:
            raise RuntimeError(f"tenant attach failed ({status}): {doc}")
        return int(doc["port"])

    def _detach_tenant_quiet(self, rec: _EngineRec) -> None:
        host = self._hosts.get(rec.share_key)
        if host is None or host.proc is None or host.proc.poll() is not None:
            rec.attached = False
            return
        try:
            self._host_request(host, "DELETE", f"/-/tenants/{rec.agent_id}")
        except Exception:
            # "quiet" means quiet: a host dying mid-DELETE raises
            # http.client exceptions that are NOT OSError subclasses
            pass
        rec.attached = False

    def _maybe_stop_host(self, key: tuple, timeout_s: float = 10.0) -> None:
        """Kill the host process once no tenant needs it (frees the chips)."""
        with self._lock:
            live = any(
                r.share_key == key and (r.desired_running or r.attached)
                for r in self._recs.values()
            )
            host = self._hosts.get(key)
        if live or host is None or host.proc is None or host.proc.poll() is not None:
            return
        try:
            host.proc.terminate()
            host.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            host.proc.kill()
            host.proc.wait(timeout=5)
        except ProcessLookupError:
            pass
        if host.log_file is not None:
            try:
                host.log_file.close()
            except OSError:
                pass

    def _tail_path(self, path: Path, tail: int) -> list[str]:
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - 256 * 1024))
                return f.read().decode("utf-8", "replace").splitlines()[-tail:]
        except OSError:
            return []

    def _spawn(self, rec: _EngineRec) -> None:
        if rec.log_file is not None:  # respawn: don't leak the old handle
            try:
                rec.log_file.close()
            except OSError:
                pass
        rec.log_file = open(rec.log_path, "ab")
        rec.env["AGENTAINER_CONTROL_URL"] = self.control_url
        rec.proc = subprocess.Popen(
            rec.cmd,
            env=rec.env,
            stdout=rec.log_file,
            stderr=subprocess.STDOUT,
            start_new_session=True,  # isolate signals from the daemon
        )
        rec.paused = False
        rec.last_spawn_at = time.monotonic()

    def _wait_ready(self, rec: _EngineRec) -> None:
        """Block until the engine answers /health (containers have no such
        gate in the reference; engines do because JAX init takes seconds and
        a 'started' engine should be servable)."""
        self._wait_port(rec.proc, rec.port, rec.log_path, f"engine {rec.engine_id}")

    def _wait_port(self, proc, port: int, log_path: Path, label: str) -> None:
        deadline = time.time() + self.ready_timeout_s
        while time.time() < deadline:
            if proc is None or proc.poll() is not None:
                raise RuntimeError(
                    f"{label} exited during startup; log: {self._tail_path(log_path, 20)}"
                )
            if self._probe(port, timeout=1.0):
                return
            time.sleep(0.05)
        raise RuntimeError(f"{label} not ready after {self.ready_timeout_s}s")

    def stop_engine(self, engine_id: str, timeout_s: float = 10.0) -> None:
        with self._lock:
            rec = self._require(engine_id)
            rec.desired_running = False
            proc = rec.proc
        if rec.share_key is not None:
            # tenant: detach from the shared host; the host itself dies only
            # when its LAST tenant is gone (the weights outlive one agent)
            self._detach_tenant_quiet(rec)
            self._maybe_stop_host(rec.share_key, timeout_s)
            self._emit(engine_id, EngineState.EXITED)
            return
        if proc is None or proc.poll() is not None:
            return
        if rec.paused:
            try:
                os.killpg(proc.pid, signal.SIGCONT)
            except (ProcessLookupError, PermissionError):
                pass
            rec.paused = False
        try:
            proc.terminate()
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()  # hard kill after grace (agent.go:194 10s deadline)
            proc.wait(timeout=5)
        except ProcessLookupError:
            pass
        self._emit(engine_id, EngineState.EXITED)

    def pause_engine(self, engine_id: str) -> None:
        with self._lock:
            rec = self._require(engine_id)
            if rec.share_key is not None:
                # tenant pause is a routing-level freeze: SIGSTOP would
                # stop the shared process and every co-tenant with it. The
                # control plane stops proxying (status=paused) and probe()
                # reports down; the engine keeps serving its co-tenants.
                if not rec.attached or not self._host_alive(rec.share_key):
                    raise RuntimeError(f"engine {engine_id} not running")
                rec.paused = True
            else:
                if rec.proc is None or rec.proc.poll() is not None:
                    raise RuntimeError(f"engine {engine_id} not running")
                os.killpg(rec.proc.pid, signal.SIGSTOP)
                rec.paused = True
        self._emit(engine_id, EngineState.PAUSED)

    def resume_engine(self, engine_id: str) -> None:
        with self._lock:
            rec = self._require(engine_id)
            if rec.share_key is not None:
                if not rec.attached or not self._host_alive(rec.share_key):
                    raise RuntimeError(f"engine {engine_id} not running")
                rec.paused = False
            else:
                if rec.proc is None or rec.proc.poll() is not None:
                    raise RuntimeError(f"engine {engine_id} not running")
                os.killpg(rec.proc.pid, signal.SIGCONT)
                rec.paused = False
        self._emit(engine_id, EngineState.RUNNING)

    def _host_alive(self, key: tuple) -> bool:
        host = self._hosts.get(key)
        return host is not None and host.proc is not None and host.proc.poll() is None

    def remove_engine(self, engine_id: str) -> None:
        with self._lock:
            rec = self._recs.pop(engine_id, None)
        if rec is None:
            return
        if rec.share_key is not None:
            self._detach_tenant_quiet(rec)
            rec.desired_running = False
            self._maybe_stop_host(rec.share_key, timeout_s=2.0)
            return
        if rec.proc is not None and rec.proc.poll() is None:
            try:
                os.killpg(rec.proc.pid, signal.SIGKILL)
                rec.proc.wait(timeout=5)
            except (ProcessLookupError, subprocess.TimeoutExpired):
                pass
        if rec.log_file is not None:
            try:
                rec.log_file.close()
            except OSError:
                pass

    def engine_info(self, engine_id: str) -> EngineInfo | None:
        with self._lock:
            rec = self._recs.get(engine_id)
            if rec is None:
                return None
            return EngineInfo(
                engine_id=engine_id,
                agent_id=rec.agent_id,
                state=self._state(rec),
                endpoint=f"http://127.0.0.1:{rec.port}",
                chips=rec.chips,
            )

    def _state(self, rec: _EngineRec) -> EngineState:
        if rec.gave_up:
            # crash-loop terminal: the watcher stopped respawning; only an
            # explicit start/resume (which clears the latch) leaves FAILED
            return EngineState.FAILED
        if rec.share_key is not None:
            if not rec.attached and not rec.desired_running:
                return EngineState.CREATED if rec.restarts == 0 else EngineState.EXITED
            if not self._host_alive(rec.share_key):
                return EngineState.EXITED if rec.attached or rec.restarts else EngineState.CREATED
            if not rec.attached:
                return EngineState.EXITED if rec.host_lost else EngineState.CREATED
            return EngineState.PAUSED if rec.paused else EngineState.RUNNING
        if rec.proc is None:
            return EngineState.CREATED
        if rec.proc.poll() is not None:
            return EngineState.EXITED
        return EngineState.PAUSED if rec.paused else EngineState.RUNNING

    def list_engines(self) -> list[EngineInfo]:
        with self._lock:
            ids = list(self._recs)
        return [info for eid in ids if (info := self.engine_info(eid)) is not None]

    def logs(self, engine_id: str, tail: int = 100) -> list[str]:
        with self._lock:
            rec = self._recs.get(engine_id)
        if rec is None:
            return []
        return self._tail_log(rec, tail)

    def log_path(self, engine_id: str) -> str | None:
        """Filesystem path of the engine's log, for follow/streaming reads
        (agent.go:411-429 GetLogs(follow) parity — the server tails this)."""
        with self._lock:
            rec = self._recs.get(engine_id)
        return None if rec is None else str(rec.log_path)

    def _tail_log(self, rec: _EngineRec, tail: int) -> list[str]:
        return self._tail_path(rec.log_path, tail)

    def stats(self, engine_id: str) -> dict | None:
        """Pull serving counters from the engine's /metrics (the
        ContainerStats analogue, collector.go:228)."""
        with self._lock:
            rec = self._recs.get(engine_id)
            if rec is None or self._state(rec) != EngineState.RUNNING:
                return None
            port = rec.port
        import http.client
        import json as _json

        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2.0)
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            data = _json.loads(resp.read()) if resp.status == 200 else None
            conn.close()
            return data
        except (OSError, ValueError):
            return None

    def host_stats(self, engine_id: str) -> dict | None:
        """Host-side process stats for the engine: CPU% (delta over the
        sampling interval) and RSS, read straight from /proc — the
        ContainerStats CPU/mem half (reference
        pkg/metrics/collector.go:249-298). The host side (tokenization,
        store I/O, HTTP) can throttle serving, so it is visible per agent."""
        with self._lock:
            rec = self._recs.get(engine_id)
            if rec is None:
                return None
            proc = rec.proc
            shared_tenants = 0
            if rec.share_key is not None:
                host = self._hosts.get(rec.share_key)
                proc = host.proc if host else None
                # the CPU%/RSS below belong to the SHARED host process: every
                # attached tenant's sample carries the same numbers, so fleet
                # aggregation must divide by the tenant count instead of
                # multiplying the process by N
                shared_tenants = sum(
                    1
                    for r in self._recs.values()
                    if r.share_key == rec.share_key and r.attached
                )
            if proc is None or proc.poll() is not None:
                return None
            pid = proc.pid
        try:
            with open(f"/proc/{pid}/stat", "rb") as f:
                fields = f.read().rsplit(b") ", 1)[-1].split()
            # fields[11]/[12] = utime/stime (fields 14/15 1-indexed, minus
            # the 3 before the stripped comm)
            jiffies = int(fields[11]) + int(fields[12])
            with open(f"/proc/{pid}/statm", "rb") as f:
                rss_pages = int(f.read().split()[1])
        except (OSError, IndexError, ValueError):
            return None
        now = time.monotonic()
        hz = os.sysconf("SC_CLK_TCK") or 100
        page = os.sysconf("SC_PAGE_SIZE") or 4096
        cpu_pct = None
        prev = self._cpu_last.get(engine_id)
        if prev is not None and prev[2] == pid:
            dt = now - prev[0]
            if dt > 0:
                cpu_pct = round(100.0 * (jiffies - prev[1]) / hz / dt, 1)
        self._cpu_last[engine_id] = (now, jiffies, pid)
        doc = {
            "pid": pid,
            "host_cpu_pct": cpu_pct,
            "host_rss_bytes": rss_pages * page,
        }
        if shared_tenants:
            doc["shared"] = True
            doc["host_tenants"] = shared_tenants
        return doc

    def probe_engine(self, engine_id: str) -> bool:
        """Real liveness: the engine answers /health. Process state alone
        lies for a beat after SIGKILL (poll() still None while the port
        already refuses) — resume() uses this to decide rehydration."""
        with self._lock:
            rec = self._recs.get(engine_id)
            if rec is None or rec.paused:
                return False
            if rec.share_key is not None:
                if not rec.attached or not self._host_alive(rec.share_key):
                    return False
            elif rec.proc is None:
                return False
            port = rec.port
        return self._probe(port)

    @staticmethod
    def _probe(port: int, timeout: float = 2.0) -> bool:
        import http.client

        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
            conn.request("GET", "/health")
            ok = conn.getresponse().status == 200
            conn.close()
            return ok
        except OSError:
            return False

    def subscribe_events(self, callback: Callable[[str, EngineState], None]) -> Callable[[], None]:
        self._listeners.append(callback)

        def unsub() -> None:
            if callback in self._listeners:
                self._listeners.remove(callback)

        return unsub

    def _emit(self, engine_id: str, state: EngineState) -> None:
        for cb in list(self._listeners):
            try:
                cb(engine_id, state)
            except Exception:
                pass

    # -- restart-policy watcher (docker events + RestartPolicy analogue) --
    #
    # Respawn policy (crash-loop backoff): the FIRST death of a healthy
    # incarnation respawns on the next 200 ms tick — single-crash recovery
    # time is unchanged. Consecutive *rapid* deaths (an incarnation that
    # lived < restart_window_s) back off exponentially
    # (restart_backoff_base_s doubling, capped at restart_backoff_max_s),
    # and past restart_max_rapid of them the agent lands FAILED with a
    # recorded reason instead of hot-respawning forever — the 0.2 s
    # hot-loop used to burn a CPU core re-paying model load for an engine
    # that dies on boot, and made the failure invisible (status flapped
    # stopped→running instead of settling anywhere diagnosable).
    def _watch_loop(self) -> None:
        last: dict[str, EngineState] = {}
        while not self._closed:
            time.sleep(0.2)
            with self._lock:
                recs = list(self._recs.values())
            for rec in recs:
                state = self._state(rec)
                if (
                    state == EngineState.EXITED
                    and rec.desired_running
                    and self._exit_code(rec) == LOAD_FAILED_EXIT
                ):
                    # the model could not load: a respawn would fail the same
                    # way (and must never come back on another device), so
                    # the crash-loop policy's terminal state applies at once
                    self._give_up(rec, "engine failed to load: " + self._load_error(rec))
                    state = self._state(rec)
                if last.get(rec.engine_id) != state:
                    if rec.engine_id in last:
                        self._emit(rec.engine_id, state)
                    last[rec.engine_id] = state
                if (
                    state == EngineState.EXITED
                    and rec.desired_running
                    and rec.auto_restart
                    and not self._closed
                ):
                    self._maybe_respawn(rec, last)

    def _exit_code(self, rec: _EngineRec) -> int | None:
        proc = rec.proc
        if rec.share_key is not None:
            host = self._hosts.get(rec.share_key)
            proc = host.proc if host else None
        return None if proc is None else proc.poll()

    def _load_error(self, rec: _EngineRec) -> str:
        """The engine's last error line in its log (the serve layer prints
        the load error there before it exits)."""
        lines = [ln for ln in self._tail_path(rec.log_path, 50) if "Error" in ln or "error" in ln]
        return lines[-1].strip() if lines else f"exit code {LOAD_FAILED_EXIT}"

    def _backoff_delay(self, rapid_deaths: int) -> float:
        """Respawn delay after the n-th consecutive rapid death: 0 for the
        first death (fast single-crash recovery), then exponential."""
        if rapid_deaths <= 1:
            return 0.0
        return min(
            self.restart_backoff_max_s,
            self.restart_backoff_base_s * (2 ** (rapid_deaths - 2)),
        )

    def _give_up(self, rec: _EngineRec, reason: str) -> None:
        rec.gave_up = True
        rec.failed_reason = reason
        rec.respawn_pending = False
        rec.next_respawn_at = 0.0
        print(
            f"[backend] engine {rec.engine_id} (agent {rec.agent_id}) FAILED: {reason}",
            flush=True,
        )

    def _maybe_respawn(self, rec: _EngineRec, last: dict[str, EngineState]) -> None:
        now = time.monotonic()
        if not rec.respawn_pending:
            # first observation of THIS death: classify it against the
            # previous incarnation's lifetime and schedule the respawn
            lived = now - rec.last_spawn_at if rec.last_spawn_at else float("inf")
            rec.rapid_deaths = (
                rec.rapid_deaths + 1 if lived < self.restart_window_s else 1
            )
            if rec.rapid_deaths > self.restart_max_rapid:
                self._give_up(
                    rec,
                    f"crash loop: {rec.rapid_deaths - 1} consecutive deaths within "
                    f"{self.restart_window_s:.0f}s of spawn (cap {self.restart_max_rapid})",
                )
                return
            rec.respawn_pending = True
            rec.next_respawn_at = now + self._backoff_delay(rec.rapid_deaths)
        if now < rec.next_respawn_at:
            return  # backing off; a later tick retries
        rec.respawn_attempts.append(now)
        del rec.respawn_attempts[:-64]  # bounded attempt log for watch_stats
        try:
            faults.fire("watcher.respawn")
            if rec.share_key is not None:
                # host died: respawn it and re-attach this tenant
                rec.attached = False
                self._ensure_host_and_attach(rec)
                rec.restarts += 1
            else:
                with self._lock:
                    self._spawn(rec)
                    rec.restarts += 1
                self._wait_ready(rec)
            rec.respawn_pending = False
            rec.next_respawn_at = 0.0
            self._emit(rec.engine_id, EngineState.RUNNING)
            last[rec.engine_id] = EngineState.RUNNING
        except Exception as e:
            # a failed respawn (spawn error, died during startup, injected
            # fault) is itself a rapid death: back off harder, and land
            # FAILED at the cap instead of abandoning the desired state
            # silently like the old watcher did
            rec.rapid_deaths += 1
            if rec.rapid_deaths > self.restart_max_rapid:
                self._give_up(rec, f"respawn failing: {type(e).__name__}: {e}")
            else:
                rec.next_respawn_at = (
                    time.monotonic() + self._backoff_delay(rec.rapid_deaths)
                )

    def watch_stats(self, engine_id: str) -> dict | None:
        """Restart-watcher accounting for the health/metrics planes: how
        many lives this engine has had, whether it is crash-looping, and
        why it was given up on."""
        with self._lock:
            rec = self._recs.get(engine_id)
            if rec is None:
                return None
            backoff = 0.0
            if rec.respawn_pending:
                backoff = max(0.0, rec.next_respawn_at - time.monotonic())
            return {
                "restarts": rec.restarts,
                "rapid_deaths": rec.rapid_deaths,
                # respawn_pending covers the backoff==0.0 windows too (an
                # attempt in flight, or the delay just elapsed): consumers
                # deciding "does the watcher own this engine's recovery"
                # must gate on it, not on the remaining-delay number
                "respawn_pending": rec.respawn_pending,
                "respawn_backoff_s": round(backoff, 3),
                "crash_looping": rec.gave_up,
                "failed_reason": rec.failed_reason or None,
                "respawn_attempts": list(rec.respawn_attempts),
            }

    def close(self) -> None:
        self._closed = True
        with self._lock:
            ids = list(self._recs)
        for engine_id in ids:
            try:
                self.stop_engine(engine_id, timeout_s=2.0)
            except Exception:
                pass
            self.remove_engine(engine_id)
        # belt-and-braces: no host process may outlive the backend (it holds
        # the GPUs)
        with self._lock:
            hosts = list(self._hosts.values())
            self._hosts.clear()
        for host in hosts:
            if host.proc is not None and host.proc.poll() is None:
                try:
                    os.killpg(host.proc.pid, signal.SIGKILL)
                    host.proc.wait(timeout=5)
                except (ProcessLookupError, subprocess.TimeoutExpired):
                    pass
            if host.log_file is not None:
                try:
                    host.log_file.close()
                except OSError:
                    pass

    def _require(self, engine_id: str) -> _EngineRec:
        rec = self._recs.get(engine_id)
        if rec is None:
            raise KeyError(f"no such engine: {engine_id}")
        return rec

    def engine_pid(self, agent_id: str) -> int | None:
        """OS pid of the live engine process serving ``agent_id`` (None when
        stopped). Public API: crash-injection tooling (bench_llm, chaos
        tests) needs the pid to simulate a container death with SIGKILL.
        For a tenant of a shared model host, this is the HOST's pid — the
        process whose death takes the agent down."""
        with self._lock:
            for rec in self._recs.values():
                if rec.agent_id != agent_id:
                    continue
                if rec.share_key is not None:
                    if not rec.attached:
                        continue  # detached tenant: the host no longer serves it
                    host = self._hosts.get(rec.share_key)
                    if host and host.proc is not None and host.proc.poll() is None:
                        return host.proc.pid
                    continue
                if rec.proc is not None and rec.proc.poll() is None:
                    return rec.proc.pid
        return None

    # -- test helper ------------------------------------------------------
    def kill_engine_hard(self, engine_id: str) -> None:
        """SIGKILL without touching desired state — a real crash. For a
        tenant this kills the shared HOST process (the realistic failure:
        the chip-owning process died, taking every co-tenant with it)."""
        with self._lock:
            rec = self._require(engine_id)
            proc = rec.proc
            if rec.share_key is not None:
                host = self._hosts.get(rec.share_key)
                proc = host.proc if host else None
            if proc is not None and proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=5)
