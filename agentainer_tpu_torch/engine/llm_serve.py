"""LLM engine process — serves the PyTorch engine over the engine HTTP
contract: ``/`` ``/health`` ``/chat`` ``/generate`` ``/history`` ``/clear``
``/cancel`` ``/profile`` ``/metrics`` ``/park`` ``/prewarm``.

Reference: ``agentainer_tpu/engine/llm_serve.py``. Same routes, same request
and response JSON, same ``AGENTAINER_*`` environment contract: the model
config, ``AGENTAINER_CHECKPOINT`` (a HuggingFace directory), the persona,
the assigned chips (``AGENTAINER_CHIPS``, passed as ``options["chips"]``)
and the fleet defaults in the ``ATPU_*`` variables (``_engine_options``).
What differs:

- the HTTP server is the port's one standard-library reader and writer
  (``utils/http``, one request per connection): the machine with the card
  has no aiohttp;
- SSE streaming (``stream=true`` on ``/chat`` with the engine's
  ``streaming`` option; a body asking for it with the option off is
  answered buffered, as in the reference): the standard-library server
  writes the reference's frames (``_sse_frame``) one at a time, draining
  each, with ``Connection: close``, each frame one chunk of a
  ``Transfer-Encoding: chunked`` body to an HTTP/1.1 request (aiohttp's
  framing, which the C++ front door needs to read a stream whole); the
  status line goes out with the first frame, so a failure before it still answers
  with its plain status (the poisoned-prefill 500 included). A client that
  hangs up is seen as end of file on the connection (``Stream.hangup``)
  and cancels its engine request;
- ``/profile`` records a ``torch.profiler`` trace (the card's kernels and
  the CPU's operators) as a Chrome trace file, where the reference records
  a ``jax.profiler`` trace; the engine's worker starts and stops it between
  its dispatches (``LLMEngine.profile``);
- ``AGENTAINER_WARM_BOOT`` has no counterpart: in the reference it skips
  warmup when the XLA compile cache is warm, but here warmup also captures
  the step graphs and replays each once, which uploads it to the device;
  skipping that would move the upload into the first requests.

Request lifecycle policy as the reference's: ``X-Agentainer-Deadline-Ms``
(or the ``default_deadline_ms`` option) sets a deadline, ``POST /cancel``
aborts a request by its ``X-Agentainer-Request-ID``, and the engine's
policy rejections answer 429 (overload), 503 + ``X-Agentainer-Draining``
(draining), 504 + ``X-Agentainer-Expired`` (deadline) and 499 (cancelled).
The persona (``system_prompt``) is prefilled into the prefix cache at load
(``prefix_prewarms``), so the first session already forks it. Both flavors
of the reference are served: ``llm`` keeps each session's KV resident;
``assistant`` (``AGENTAINER_ENGINE=assistant``, or ``flatten_history`` /
``history_turns`` in the options of either flavor) flattens the persona and
the session's last exchanges into one prompt per turn and generates it
statelessly (``_flattened_prompt``), with a default persona of its own.

Under a control plane (``AGENTAINER_CONTROL_URL`` + the engine's token)
conversation turns and KV snapshots go to the daemon's store through
``runtime/store_client.py`` (over the native store's unix socket,
``AGENTAINER_STORE_SOCK``, when the daemon runs the C++ data plane; a
tenant inherits its host's), as in the reference: a debounced snapshot of a
session's KV after each turn (``kv_snapshot_interval_s``, 10 s), the
restore of an unknown session from the store before its turn is admitted
(``kv_restores``), final snapshots of every resident session in the drain,
``/park`` writing its blob to the store (the cold tier) and ``/prewarm``
restoring from it when the host tier no longer holds the session, and a
ready callback to ``/internal/engines/ready`` once the model is loaded;
a model that cannot load makes the process exit with code 3 (the backend
lands the agent FAILED with the error from this log). With no control
plane the store client keeps turns in process memory, nothing is
snapshotted, and a model that cannot load leaves ``/chat`` answering 503
with the error.

The multi-tenant host (``AGENTAINER_HOST_TOKEN`` set by the backend) owns
the one engine; ``POST /-/tenants`` attaches an agent as a tenant — its
own localhost port, store identity, persona and counters over the shared
engine — and ``DELETE /-/tenants/{agent_id}`` detaches it. Engine sessions
are namespaced ``{agent_id}::{session}``.

Engine options ride ``AGENTAINER_MODEL_OPTIONS`` (JSON), including
``device`` (default ``"cuda"``). Run: ``python -m
agentainer_tpu_torch.engine.llm_serve`` with ``AGENTAINER_PORT`` and
``AGENTAINER_MODEL_CONFIG`` set.
"""

from __future__ import annotations

import asyncio
import hmac
import json
import os
import signal
import threading
import time
import traceback

from .. import faults
from ..core.protocol import (
    DEADLINE_HEADER,
    DRAINING_HEADER,
    EXPIRED_HEADER,
    LAST_EVENT_ID_HEADER,
    LOADING_HEADER,
    PREFILL_POISON_HEADER,
    REQUEST_ID_HEADER,
    STREAM_CONTENT_TYPE,
    STREAM_EVENT_DONE,
    STREAM_EVENT_TOKEN,
)
from ..runtime.store_client import StoreClient
from ..utils import http
from ..utils.http import Request, Response

# engine option ← its fleet-default variable (the reference's list); a
# per-deployment option wins, and 1/true/yes are true
FLEET_FLAGS = (
    ("speculative", "ATPU_SPECULATIVE"),
    ("paged_kv", "ATPU_PAGED_KV"),
    ("adaptive_decode", "ATPU_ADAPTIVE_DECODE"),
    ("prefix_cache", "ATPU_PREFIX_CACHE"),
    ("deadlines", "ATPU_DEADLINES"),
    ("fused_decode", "ATPU_FUSED_DECODE"),
    ("inloop_spec", "ATPU_INLOOP_SPEC"),
    ("approx_topk", "ATPU_APPROX_TOPK"),
    ("kv_tiering", "ATPU_KV_TIERING"),
    ("streaming", "ATPU_STREAMING"),
)
MAX_TURNS = 50
SESSION_CONVO_TTL_S = 7 * 24 * 3600
KV_SNAPSHOT_TTL_S = 24 * 3600
# the process exits with this code when its model cannot load under a
# control plane (runtime/local.py's LOAD_FAILED_EXIT)
LOAD_FAILED_EXIT = 3
# the assistant flavor's persona when the deployment names none
ASSISTANT_PERSONA = "You are a helpful, concise assistant."


def _sse_frame(event: str, event_id: int | None, data: dict) -> bytes:
    """One SSE frame: optional ``id:`` (token offset — doubles as the
    client's Last-Event-ID resume cursor), ``event:``, one-line data."""
    lines = [f"event: {event}"]
    if event_id is not None:
        lines.append(f"id: {event_id}")
    lines.append(f"data: {json.dumps(data, separators=(',', ':'))}")
    return ("\n".join(lines) + "\n\n").encode()


class LLMServeApp:
    """One agent's serving surface: one per process (env-configured), or
    several sharing one process and one engine under the multi-tenant host.
    The host instance owns the engine; tenants delegate ``engine`` and
    readiness to it while keeping their own identity (store credentials,
    conversation keys, KV snapshots, counters, persona)."""

    def __init__(self, env: dict | None = None, host: "LLMServeApp | None" = None) -> None:
        E = os.environ if env is None else env
        self._env = E
        self._host = host
        self._engine = None
        self._engine_error = ""
        self.agent_id = E.get("AGENTAINER_AGENT_ID", "standalone")
        self.agent_name = E.get("AGENTAINER_AGENT_NAME", self.agent_id)
        self.config_name = E.get("AGENTAINER_MODEL_CONFIG", "tiny")
        self.checkpoint = E.get("AGENTAINER_CHECKPOINT", "")
        self.system_prompt = E.get("AGENTAINER_SYSTEM_PROMPT", "")
        # the "assistant" flavor (the reference's second example agent): a
        # persona that flattens the session's recent turns into one prompt
        # per turn and generates statelessly, instead of keeping the
        # session's KV resident
        self.flavor = E.get("AGENTAINER_ENGINE", "llm")
        self.chips = tuple(int(c) for c in E.get("AGENTAINER_CHIPS", "0").split(",") if c != "")
        try:
            self.model_options = json.loads(E.get("AGENTAINER_MODEL_OPTIONS", "") or "{}")
        except json.JSONDecodeError:
            self.model_options = {}
        # both knobs work on the llm flavor too
        self.flatten_history = self.flavor == "assistant" or bool(
            self.model_options.get("flatten_history")
        )
        self.history_turns = int(self.model_options.get("history_turns", 3))
        if not self.system_prompt:
            self.system_prompt = str(self.model_options.get("system_prompt", ""))
        if self.flavor == "assistant" and not self.system_prompt:
            self.system_prompt = ASSISTANT_PERSONA
        try:
            self.replica = int(E.get("AGENTAINER_REPLICA", "0") or 0)
        except ValueError:
            self.replica = 0
        self.store = StoreClient(
            control_url=E.get("AGENTAINER_CONTROL_URL", ""),
            token=E.get("AGENTAINER_INTERNAL_TOKEN", ""),
            agent_id=E.get("AGENTAINER_AGENT_ID", ""),
            store_sock=E.get("AGENTAINER_STORE_SOCK", ""),
        )
        # multi-tenant host state (host instance only): agent id → (app,
        # server, port)
        self._tenants: dict[str, tuple[LLMServeApp, asyncio.AbstractServer, int]] = {}
        self._host_token = E.get("AGENTAINER_HOST_TOKEN", "")
        # KV snapshots to the store: at most one per session per interval,
        # with a trailing capture so the end of a burst of turns is kept
        try:
            self.kv_snapshot_interval_s = float(self.model_options.get("kv_snapshot_interval_s", 10.0))
        except (TypeError, ValueError):
            self.kv_snapshot_interval_s = 10.0
        self._kv_last_snap: dict[str, float] = {}
        self._kv_deferred: set[str] = set()
        self._bg_tasks: set[asyncio.Task] = set()  # keep snapshot tasks alive
        self._snap_tasks: set[asyncio.Task] = set()
        self.kv_snapshots = 0
        self.kv_snapshots_deferred = 0
        self.kv_snapshot_errors = 0
        self.last_kv_snapshot_error = ""
        # the last landed snapshot: blob bytes, the engine call's ms (the
        # staging limiter's waits included) and its stage / pack ms, and the
        # store's ms (base64 + the store op)
        self.last_kv_snapshot: dict | None = None
        self.kv_restores = 0
        # the last store restore: blob bytes, the store read and the
        # engine's restore, in ms
        self.last_kv_restore: dict | None = None
        # drain on the way out: budget, outcome, final snapshots
        try:
            self.drain_budget_s = float(
                self.model_options.get("drain_budget_s", E.get("AGENTAINER_DRAIN_BUDGET_S", 10.0))
            )
        except (TypeError, ValueError):
            self.drain_budget_s = 10.0
        self.draining = False
        self.drained_clean: bool | None = None
        self.drain_snapshots = 0
        self.prefix_prewarms = 0
        # the tiered KV hierarchy's park and prewarm hints
        self.kv_parks = 0
        self.kv_park_errors = 0
        self.kv_prewarms = 0
        self.kv_prewarm_errors = 0
        # SSE streaming: the keep-alive cadence (per deployment, else the
        # fleet default) and the stream counters
        try:
            self.stream_heartbeat_s = float(
                self.model_options.get("stream_heartbeat_s", E.get("ATPU_STREAM_HEARTBEAT_S", 15.0))
            )
        except (TypeError, ValueError):
            self.stream_heartbeat_s = 15.0
        self.streams_started = 0
        self.stream_tokens_emitted = 0
        self.stream_heartbeats = 0
        self.stream_client_disconnects = 0
        self._profiling = False
        self.started_at = time.time()
        self.requests_total = 0
        self.unhandled_errors = 0
        self.last_unhandled_error = ""
        self.port: int | None = None
        self._ready = threading.Event()  # set once the loader finished (or died)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop: asyncio.Event | None = None
        self._routes = {
            ("GET", "/"): self.h_root,
            ("GET", "/health"): self.h_health,
            ("POST", "/chat"): self.h_chat,
            ("POST", "/generate"): self.h_generate,
            ("GET", "/history"): self.h_history,
            ("POST", "/clear"): self.h_clear,
            ("POST", "/cancel"): self.h_cancel,
            ("POST", "/profile"): self.h_profile,
            ("GET", "/metrics"): self.h_metrics,
            ("POST", "/park"): self.h_park,
            ("POST", "/prewarm"): self.h_prewarm,
        }
        if self._host_token:
            # the multi-tenant host's admin surface (the backend holds the
            # host token it minted at spawn)
            self._routes[("POST", "/-/tenants")] = self.h_tenant_attach

    # engine and load state delegate to the host when this app is a tenant:
    # one LLMEngine (one weight copy) serves every attached agent
    @property
    def engine(self):
        return self._host.engine if self._host is not None else self._engine

    @engine.setter
    def engine(self, value) -> None:
        self._engine = value

    @property
    def engine_error(self) -> str:
        return self._host.engine_error if self._host is not None else self._engine_error

    @engine_error.setter
    def engine_error(self, value: str) -> None:
        self._engine_error = value

    @property
    def ready_event(self) -> threading.Event:
        return self._host.ready_event if self._host is not None else self._ready

    def _sess(self, session: str) -> str:
        """Engine-side session namespace: tenants sharing one engine never
        collide on KV slots."""
        return f"{self.agent_id}::{session}"

    @property
    def convo_key(self) -> str:
        return f"agent:{self.agent_id}:conversations"

    def _convo_session_key(self, session: str) -> str:
        return f"{self.convo_key}:{session}"

    def _kv_key(self, session: str) -> str:
        return f"agent:{self.agent_id}:kvcache:{session}"

    def _engine_options(self) -> dict:
        """The engine's options: the deployment's own
        (``AGENTAINER_MODEL_OPTIONS``) over the fleet defaults of
        ``FLEET_FLAGS``, and the assigned chips."""
        opts = dict(self.model_options)
        for flag, env_name in FLEET_FLAGS:
            raw = self._env.get(env_name)
            if raw is not None and flag not in opts:
                opts[flag] = raw.lower() in ("1", "true", "yes")
        if self.chips:
            opts["chips"] = list(self.chips)
        return opts

    def _background(self, coro) -> asyncio.Task:
        task = asyncio.ensure_future(coro)
        self._bg_tasks.add(task)  # an unreferenced task can be collected mid-flight
        task.add_done_callback(self._bg_tasks.discard)
        return task

    def _schedule_snapshot(self, session: str) -> None:
        """The turn's snapshot, off the request's path; counted in flight
        until it has landed, bounced or failed (``kv_snapshots_in_flight``)."""
        task = self._background(self._snapshot_session(session))
        self._snap_tasks.add(task)
        task.add_done_callback(self._snap_tasks.discard)

    # -- lifecycle ----------------------------------------------------------
    def _load_engine(self) -> None:
        """Build the engine (weights + warmup: slow), prefill every persona
        of the host and its tenants into the prefix cache, then tell each
        control plane the model is ready. Runs on a daemon thread so
        /health answers while loading. Under a control plane a model that
        cannot load ends the process (``LOAD_FAILED_EXIT``)."""
        try:
            from .llm import LLMEngine

            engine = LLMEngine.create(
                config_name=self.config_name,
                checkpoint=self.checkpoint,
                options=self._engine_options(),
            )

            async def prewarm_all() -> None:
                await self._prewarm_prefix(engine)
                for tenant, _, _ in list(self._tenants.values()):
                    await tenant._prewarm_prefix(engine)

            asyncio.run(prewarm_all())
            self.engine = engine
        except Exception as e:  # engine stays None; /chat reports 503
            self.engine_error = f"{type(e).__name__}: {e}"
            traceback.print_exc()
            if self._env.get("AGENTAINER_CONTROL_URL"):
                print(f"[llm-serve] model failed to load: {self.engine_error}", flush=True)
                os._exit(LOAD_FAILED_EXIT)
        finally:
            self._ready.set()
        if self.engine is not None:
            self._fan_out_ready()

    async def _prewarm_prefix(self, engine) -> None:
        """Register the persona header in the engine's prefix cache before
        traffic arrives: a 1-token generation of ``"{persona}\\n\\n"``
        prefills and caches its bucket prefixes, which every chat that opens
        with ``f"{system_prompt}\\n\\n{message}"`` forks. Best effort."""
        if not self.system_prompt or not getattr(engine, "prefix_cache", False):
            return
        try:
            await engine.generate(prompt=f"{self.system_prompt}\n\n", max_tokens=1)
            self.prefix_prewarms += 1
        except Exception as e:  # logged; serving goes on without the prewarm
            print(f"[llm-serve] persona prefix prewarm failed: {type(e).__name__}: {e}", flush=True)

    def _notify_ready(self) -> None:
        """Tell the control plane the model is servable, so queued requests
        replay now rather than on the next scan tick (best effort, never
        fatal: the replay scan stays the safety net)."""
        url, token = self.store.control_url, self.store.token
        if not url or not token:
            return  # standalone runs and the identity-less host skip it
        try:
            from http.client import HTTPConnection
            from urllib.parse import urlsplit

            u = urlsplit(url)
            conn = HTTPConnection(u.hostname, u.port or 80, timeout=5.0)
            conn.request(
                "POST",
                "/internal/engines/ready",
                body=b"{}",
                headers={
                    "X-Agentainer-Agent-ID": self.agent_id,
                    "Authorization": f"Bearer {token}",
                    "Content-Type": "application/json",
                },
            )
            conn.getresponse().read()
            conn.close()
        except Exception as e:
            print(f"[llm-serve] ready callback failed for {self.agent_id}: {type(e).__name__}: {e}", flush=True)

    def _fan_out_ready(self) -> None:
        """The ready callback for this app and every attached tenant; one
        tenant's failure does not skip the rest."""
        self._notify_ready()
        for tenant, _, _ in list(self._tenants.values()):
            tenant._notify_ready()

    async def run(self, host: str = "127.0.0.1", port: int = 8000) -> None:
        """Serve until ``stop()``; loads the engine in the background unless
        one was injected before. On the way out the engine drains (no new
        admissions, 503 + draining; in-flight work finishes within
        ``drain_budget_s``), every resident session of the host and its
        tenants gets a final snapshot in the store, the tenants detach, the
        server closes and the engine shuts down."""
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        if self.engine is None:
            threading.Thread(target=self._load_engine, daemon=True, name="model-loader").start()
        else:
            self._ready.set()
            threading.Thread(target=self._fan_out_ready, daemon=True).start()
        server = await http.start_server(self._dispatch, host, port)
        self.port = server.sockets[0].getsockname()[1]
        try:
            await self._stop.wait()
            if self.engine is not None:
                await self._graceful_drain()
        finally:
            for aid in list(self._tenants):
                await self._detach_tenant(aid)
            server.close()
            await server.wait_closed()
            if self.engine is not None:
                await asyncio.to_thread(self.engine.shutdown)

    def stop(self) -> None:
        """Thread-safe: ask ``run`` to drain the engine and return."""
        if self._loop is not None and self._stop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)

    async def _graceful_drain(self) -> None:
        """The SIGTERM half of a rolling restart: stop admitting, let
        in-flight lanes finish inside the drain budget, then snapshot every
        resident session (the host's and each tenant's) so the respawned
        engine restores them token-identical."""
        eng = self.engine
        self.draining = True
        self.drained_clean = await asyncio.to_thread(eng.drain, self.drain_budget_s)
        # the engine is idle now: the snapshot limiter has nothing to protect
        eng.snapshot_min_gap_s = 0.0
        eng.snapshot_busy_gap_s = 0.0
        for app in [self] + [t for t, _, _ in self._tenants.values()]:
            if not app.store.connected:
                continue
            prefix = f"{app.agent_id}::"
            for name in [s for s in list(eng.sessions) if s.startswith(prefix)]:
                before = app.kv_snapshots
                await app._snapshot_now(name[len(prefix):])
                if app.kv_snapshots > before:
                    self.drain_snapshots += 1

    # -- KV snapshots in the store -------------------------------------------
    async def _snapshot_session(self, session: str) -> None:
        """Snapshot after a turn settles, off the request's path. Debounced
        per session: a burst of turns costs one leading snapshot plus one
        trailing capture, not one per turn."""
        now = time.monotonic()
        last = self._kv_last_snap.get(session)
        if last is not None and now - last < self.kv_snapshot_interval_s:
            if session in self._kv_deferred:
                return  # a deferred capture is pending; it will see this turn
            self._kv_deferred.add(session)
            try:
                await asyncio.sleep(last + self.kv_snapshot_interval_s - now)
            finally:
                self._kv_deferred.discard(session)
        await self._snapshot_now(session)

    async def _snapshot_now(self, session: str) -> None:
        from .llm import SnapshotDeferred

        try:
            t0 = time.monotonic()
            blob = await self.engine.snapshot_session(self._sess(session))
            if blob:
                self._kv_last_snap[session] = time.monotonic()
                t1 = time.monotonic()
                path = await self.store.set_bytes(self._kv_key(session), blob, ttl=KV_SNAPSHOT_TTL_S)
                self.kv_snapshots += 1
                self.last_kv_snapshot = {
                    "session": session,
                    "bytes": len(blob),
                    "snapshot_ms": 1000 * (t1 - t0),  # the limiter's waits included
                    "store_ms": 1000 * (time.monotonic() - t1),
                    "path": path,  # socket, http or local
                }
                timings = getattr(self.engine, "snapshot_timings", None)
                if timings and timings[-1].get("blob_bytes") == len(blob):
                    # the engine's own staging copy and npz pack
                    self.last_kv_snapshot.update(
                        stage_ms=timings[-1]["stage_ms"], pack_ms=timings[-1]["pack_ms"]
                    )
        except SnapshotDeferred:
            # busy engine / limiter: the next turn retries; counted
            self.kv_snapshots_deferred += 1
        except Exception as e:
            self.kv_snapshot_errors += 1
            self.last_kv_snapshot_error = f"{type(e).__name__}: {e}"
            print(f"[llm-serve] kv snapshot failed: {self.last_kv_snapshot_error}", flush=True)

    async def _restore_from_store(self, session: str) -> bool:
        """Crash-resume: load a session's snapshot from the store into the
        engine (best effort); True when it was restored."""
        try:
            t0 = time.monotonic()
            blob = await self.store.get_bytes(self._kv_key(session))
            t1 = time.monotonic()
            if blob and await self.engine.restore_session(self._sess(session), blob):
                self.kv_restores += 1
                self.last_kv_restore = {
                    "session": session,
                    "bytes": len(blob),
                    "store_ms": 1000 * (t1 - t0),
                    "restore_ms": 1000 * (time.monotonic() - t1),
                }
                return True
        except Exception as e:
            print(f"[llm-serve] kv restore failed: {type(e).__name__}: {e}", flush=True)
        return False

    # -- multi-tenant host admin ---------------------------------------------
    def _check_host_auth(self, req: Request) -> bool:
        presented = req.headers.get("Authorization", "").removeprefix("Bearer ").strip()
        return bool(self._host_token) and hmac.compare_digest(
            presented.encode(), self._host_token.encode()
        )

    async def h_tenant_attach(self, req: Request) -> Response:
        """Attach an agent to this host: a serving surface on its own
        localhost port over this process's engine (one weight copy)."""
        if not self._check_host_auth(req):
            return Response(401, {"error": "bad host token"})
        try:
            body = req.json()
        except ValueError:
            return Response(400, {"error": "invalid JSON"})
        aid = str((body or {}).get("agent_id", ""))
        if not aid:
            return Response(400, {"error": "agent_id required"})
        if aid in self._tenants:  # idempotent re-attach (respawn race)
            return Response(200, {"port": self._tenants[aid][2], "existing": True})
        tenant_env = {
            "AGENTAINER_AGENT_ID": aid,
            "AGENTAINER_AGENT_NAME": str(body.get("name", aid)),
            "AGENTAINER_ENGINE": str(body.get("flavor", "llm")),
            "AGENTAINER_MODEL_CONFIG": self.config_name,
            "AGENTAINER_CHECKPOINT": self.checkpoint,
            "AGENTAINER_MODEL_OPTIONS": json.dumps(body.get("options", {}) or {}),
            "AGENTAINER_SYSTEM_PROMPT": str(body.get("system_prompt", "")),
            "AGENTAINER_CONTROL_URL": self.store.control_url,
            "AGENTAINER_STORE_SOCK": self.store.store_sock,
            "AGENTAINER_INTERNAL_TOKEN": str(body.get("token", "")),
            "AGENTAINER_CHIPS": ",".join(map(str, self.chips)),
            # a host serves one replica ordinal of each of its agents
            "AGENTAINER_REPLICA": str(self.replica),
        }
        tenant = LLMServeApp(env=tenant_env, host=self)
        server = await http.start_server(tenant._dispatch, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        tenant.port = port
        self._tenants[aid] = (tenant, server, port)
        if self.engine is not None:
            # the tenant's persona into the shared prefix cache now, and the
            # ready callback off the loop (blocking HTTP)
            self._background(tenant._prewarm_prefix(self.engine))
            asyncio.get_running_loop().run_in_executor(None, tenant._notify_ready)
        print(f"[llm-serve] tenant {aid} attached on :{port}", flush=True)
        return Response(200, {"port": port})

    async def _detach_tenant(self, aid: str) -> bool:
        entry = self._tenants.pop(aid, None)
        if entry is None:
            return False
        tenant, server, _ = entry
        if self.engine is not None:
            await asyncio.to_thread(self.engine.clear_sessions, f"{aid}::")
        server.close()
        await tenant.store.close()
        print(f"[llm-serve] tenant {aid} detached", flush=True)
        return True

    async def h_tenant_detach(self, req: Request, aid: str) -> Response:
        if not self._check_host_auth(req):
            return Response(401, {"error": "bad host token"})
        if not await self._detach_tenant(aid):
            return Response(404, {"error": f"no tenant {aid}"})
        return Response(200, {"detached": aid, "remaining": len(self._tenants)})

    # -- HTTP ---------------------------------------------------------------
    async def _dispatch(self, req: Request) -> Response:
        handler = self._routes.get((req.method, req.path))
        if handler is None:
            if self._host_token and req.method == "DELETE" and req.path.startswith("/-/tenants/"):
                return await self.h_tenant_detach(req, req.path[len("/-/tenants/"):])
            if any(path == req.path for _, path in self._routes):
                return Response(405, {"error": f"method {req.method} not allowed"})
            return Response(404, {"error": f"no route {req.path}"})
        try:
            return await handler(req)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            from .llm import PrefillFailed

            resp = self._policy_response(e)
            if resp is not None:
                return resp
            # any other handler error becomes a JSON 500 carrying the
            # exception string, with the traceback in the engine log
            self.unhandled_errors += 1
            self.last_unhandled_error = f"{type(e).__name__}: {e}"
            print(
                f"[llm-serve] {req.method} {req.path} failed:\n{traceback.format_exc()}",
                flush=True,
            )
            headers = {PREFILL_POISON_HEADER: "true"} if isinstance(e, PrefillFailed) else None
            return Response(
                500,
                {"error": self.last_unhandled_error, "path": req.path, "agent_id": self.agent_id},
                headers,
            )

    def _policy_response(self, e: BaseException) -> Response | None:
        """The engine's lifecycle-policy rejections as HTTP, as the
        reference maps them; None for a real error."""
        from .llm import EngineDraining, EngineOverloaded, RequestCancelled, RequestExpired

        if isinstance(e, EngineOverloaded):
            return Response(
                429,
                {"error": str(e), "depth": e.depth, "watermark": e.watermark},
                {"Retry-After": str(max(1, int(round(e.retry_after_s))))},
            )
        if isinstance(e, EngineDraining):
            return Response(
                503, {"error": "engine draining for restart"},
                {DRAINING_HEADER: "true", "Retry-After": "5"},
            )
        if isinstance(e, RequestExpired):
            return Response(504, {"error": str(e)}, {EXPIRED_HEADER: "true"})
        if isinstance(e, RequestCancelled):
            # the expiry marker too: a cancellation is not a completed reply
            return Response(499, {"error": str(e)}, {EXPIRED_HEADER: "true"})
        return None

    def _deadline_from(self, req: Request) -> dict:
        """``{"deadline_at": t}`` from the deadline header (remaining ms),
        else the ``default_deadline_ms`` option; empty for none."""
        raw = req.headers.get(DEADLINE_HEADER.lower(), "") or self.model_options.get(
            "default_deadline_ms", ""
        )
        try:
            ms = float(raw)
        except (TypeError, ValueError):
            return {}
        return {"deadline_at": time.time() + ms / 1000.0} if ms > 0 else {}

    async def _ensure_engine(self) -> Response | None:
        """While the model loads, answer fast with a "loading" marker (after
        a short bounded wait) instead of stalling the handler."""
        if self.engine is None and not self.engine_error:
            await asyncio.to_thread(self.ready_event.wait, 2.0)
        if self.engine is not None:
            return None
        if self.engine_error:
            return Response(503, {"error": f"model runtime failed to load: {self.engine_error}"})
        return Response(503, {"error": "model loading"}, {LOADING_HEADER: "true"})

    # -- handlers -------------------------------------------------------------
    async def h_root(self, req: Request) -> Response:
        return Response(
            200,
            {
                "agent": self.agent_name,
                "engine": "llm",
                "model": self.config_name,
                "chips": list(self.chips),
                "status": "running" if self.engine else "loading",
            },
        )

    async def h_health(self, req: Request) -> Response:
        self.requests_total += 1
        host = self._host if self._host is not None else self
        return Response(
            200,
            {
                "status": "draining" if host.draining else "healthy",
                "agent_id": self.agent_id,
                "model_loaded": self.engine is not None,
                "uptime_s": time.time() - self.started_at,
            },
        )

    async def h_chat(self, req: Request) -> Response:
        self.requests_total += 1
        err = await self._ensure_engine()
        if err is not None:
            return err
        try:
            body = req.json()
        except ValueError:
            return Response(400, {"error": "invalid JSON"})
        if not isinstance(body, dict):
            return Response(400, {"error": "invalid JSON"})
        message = str(body.get("message", ""))
        session = str(body.get("session", "default"))
        max_tokens = int(body.get("max_tokens", 64))
        request_id = req.headers.get(REQUEST_ID_HEADER.lower(), "")
        kw = {"ignore_eos": True} if body.get("ignore_eos") else {}
        kw.update(self._deadline_from(req))
        # SSE is opt-in per request and per engine (its streaming option):
        # with the option off a stream=true body is answered buffered
        stream = (
            bool(body.get("stream"))
            and bool(getattr(self.engine, "streaming", False))
            and req.stream is not None
        )
        if self.flatten_history:
            # the assistant's turn: persona + the session's last exchanges
            # flattened into one prompt, generated statelessly (no session)
            prompt = await self._flattened_prompt(session, message)
            if stream:
                return await self._chat_streamed(
                    req, session, message, prompt, max_tokens, request_id, kw, flatten=True
                )
            result = await self.engine.generate(
                prompt=prompt, max_tokens=max_tokens, request_id=request_id, **kw
            )
            await self._record_turn(session, message, result["text"])
            return Response(
                200,
                {
                    "response": result["text"],
                    "agent": self.agent_name,
                    "model": self.config_name,
                    "persona": self.system_prompt,
                    "usage": {
                        "prompt_tokens": result["prompt_tokens"],
                        "completion_tokens": result["completion_tokens"],
                    },
                    "ttft_ms": result.get("ttft_ms"),
                },
            )
        # crash-resume: an unknown session may have a KV snapshot in the
        # store from an earlier engine life — restore it before generating,
        # so the conversation continues from its exact context (a session
        # parked in the host tier is known: it promotes at admission)
        if self.store.connected and not self.engine.has_session(self._sess(session)):
            await self._restore_from_store(session)
        # persona parity: a brand-new session's context opens with the
        # system prompt; later turns inherit it through the KV cache
        prompt = message
        if self.system_prompt and not self.engine.has_session(self._sess(session)):
            prompt = f"{self.system_prompt}\n\n{message}"
        if stream:
            return await self._chat_streamed(
                req, session, message, prompt, max_tokens, request_id, kw, flatten=False
            )
        result = await self.engine.chat(
            session=self._sess(session),
            message=prompt,
            max_tokens=max_tokens,
            request_id=request_id,
            **kw,
        )
        if self.store.connected:
            self._schedule_snapshot(session)
        await self._record_turn(session, message, result["text"])
        return Response(200, self._chat_payload(result))

    def _chat_payload(self, result: dict) -> dict:
        """The buffered /chat body of an engine result (also the ``done``
        event's data of a stream)."""
        return {
            "response": result["text"],
            "agent": self.agent_name,
            "model": self.config_name,
            "usage": {
                "prompt_tokens": result["prompt_tokens"],
                "completion_tokens": result["completion_tokens"],
            },
            "ttft_ms": result.get("ttft_ms"),
            "ttft_breakdown": result.get("ttft_breakdown"),
        }

    async def _chat_streamed(
        self,
        req: Request,
        session: str,
        message: str,
        prompt: str,
        max_tokens: int,
        request_id: str,
        kw: dict,
        flatten: bool,
    ) -> Response:
        """SSE token stream of one /chat turn (the reference's
        ``_chat_streamed``). Every ``token`` event carries a monotone offset
        (its ``id:``) into the request's deterministic token sequence;
        ``done`` closes with the buffered path's exact payload. A resumed
        request (the same request id) re-emits from offset 0 and this layer
        skips every offset at or below the ``Last-Event-ID`` cursor; a
        memoized replay returns its result with no live emits, and the
        catch-up below re-emits it under the same offsets. Comment frames
        keep an idle connection open through a long prefill and never
        advance an offset. A client that hangs up cancels the engine
        request."""
        self.streams_started += 1
        out = req.stream
        out.headers = {
            "Content-Type": STREAM_CONTENT_TYPE,
            "Cache-Control": "no-cache",
            "X-Accel-Buffering": "no",
        }
        # the engine's cancel needs an id; a direct client may send none
        rid = request_id or f"stream-{time.monotonic_ns()}"
        try:
            last_acked = int(req.headers.get(LAST_EVENT_ID_HEADER.lower(), ""))
        except ValueError:
            last_acked = -1
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def emit(start: int, ids: list) -> None:  # worker thread → loop
            loop.call_soon_threadsafe(q.put_nowait, (start, list(ids)))

        if flatten:
            gen = self.engine.generate(
                prompt=prompt, max_tokens=max_tokens, request_id=rid, emit=emit, **kw
            )
        else:
            gen = self.engine.chat(
                session=self._sess(session), message=prompt, max_tokens=max_tokens,
                request_id=rid, emit=emit, **kw,
            )
        task = asyncio.ensure_future(gen)

        def on_done(t: asyncio.Task) -> None:
            if not t.cancelled():
                t.exception()  # retrieved here; the loop below reads the result
            q.put_nowait(("__done__", t))

        task.add_done_callback(on_done)
        tokens: list[int] = []  # the emission sequence seen so far
        text = ""  # its decoded text; each event carries the delta

        async def send_tokens(start: int, ids: list) -> None:
            nonlocal text
            for i, tid in enumerate(ids):
                off = start + i
                if off < len(tokens):
                    continue  # already seen
                tokens.append(int(tid))
                new_text = self.engine.tokenizer.decode(tokens)
                delta, text = new_text[len(text):], new_text
                if off <= last_acked:
                    continue  # the consumer holds it already
                # failpoint: the per-event emission seam; an armed error
                # truncates the stream (no done frame)
                await faults.fire_async("engine.stream")
                await out.write(
                    _sse_frame(STREAM_EVENT_TOKEN, off, {"offset": off, "token": int(tid), "text": delta})
                )
                self.stream_tokens_emitted += 1

        hangup = out.hangup()
        streamed = Response(200, None, streamed=True)
        try:
            while True:
                getter = asyncio.ensure_future(q.get())
                done, _ = await asyncio.wait(
                    {getter, hangup},
                    timeout=max(0.05, self.stream_heartbeat_s),
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if getter not in done:
                    getter.cancel()
                    if hangup in done:
                        raise ConnectionResetError("the client closed the stream")
                    await out.write(b": keep-alive\n\n")
                    self.stream_heartbeats += 1
                    continue
                item = getter.result()
                if item[0] == "__done__":
                    try:
                        result = item[1].result()
                    except Exception as e:
                        if not out.started:
                            # nothing sent yet: the buffered path's statuses
                            # (a poisoned prefill's 500 through _dispatch)
                            resp = self._policy_response(e)
                            if resp is None:
                                raise
                            return resp
                        # bytes went out: close without a done frame
                        return streamed
                    break
                await send_tokens(*item)
            while not q.empty():  # emits that landed beside the result
                item = q.get_nowait()
                if item[0] != "__done__":
                    await send_tokens(*item)
            # a memoized replay (or a lost tail): catch up from the result
            await send_tokens(len(tokens), list(result.get("tokens") or [])[len(tokens):])
            if self.store.connected and not flatten:
                self._schedule_snapshot(session)
            await self._record_turn(session, message, result["text"])
            payload = self._chat_payload(result)
            if flatten:
                payload["persona"] = self.system_prompt
            await out.write(
                _sse_frame(STREAM_EVENT_DONE, len(tokens) - 1 if tokens else None, payload)
            )
            return streamed
        except asyncio.CancelledError:
            self.stream_client_disconnects += 1
            self.engine.cancel(rid)
            raise
        except ConnectionError:
            self.stream_client_disconnects += 1
            self.engine.cancel(rid)
            return streamed if out.started else Response(499, {"error": "client disconnected"})
        except Exception:
            if not out.started:
                raise
            self.engine.cancel(rid)
            return streamed
        finally:
            hangup.cancel()

    async def _session_turns(self, session: str, window: int) -> list[dict]:
        """The last ``window`` turns of one session, from its own list,
        filled up from the legacy shared conversation key (turns recorded
        before the per-session lists) when the list holds fewer."""
        try:
            raw = await self.store.lrange(self._convo_session_key(session), -window, -1)
        except Exception:
            raw = []
        turns = []
        for item in raw:
            try:
                turns.append(json.loads(item))
            except json.JSONDecodeError:
                continue
        if len(turns) >= window:
            return turns
        try:
            legacy = await self.store.lrange(self.convo_key, 0, -1)
        except Exception:
            legacy = []
        legacy_turns = []
        for item in legacy:
            try:
                t = json.loads(item)
            except json.JSONDecodeError:
                continue
            if t.get("session", "default") == session:
                legacy_turns.append(t)
        return (legacy_turns + turns)[-window:]

    async def _flattened_prompt(self, session: str, message: str) -> str:
        """Persona + the session's last ``history_turns`` exchanges as one
        prompt string (the reference's). Turn N+1's prompt shares turn N's
        tokens up to where the window slides, so the prefix cache forks
        what it can."""
        lines: list[str] = []
        for t in await self._session_turns(session, 2 * self.history_turns):
            who = "User" if t.get("role") == "user" else "Assistant"
            lines.append(f"{who}: {t.get('content', '')}")
        lines.append(f"User: {message}")
        lines.append("Assistant:")
        history = "\n".join(lines)
        return f"{self.system_prompt}\n\n{history}" if self.system_prompt else history

    async def _record_turn(self, session: str, message: str, reply: str) -> None:
        now = time.time()
        key = self._convo_session_key(session)
        try:
            await self.store.rpush(
                key,
                json.dumps({"role": "user", "content": message, "ts": now, "session": session}),
                json.dumps({"role": "assistant", "content": reply, "ts": now, "session": session}),
            )
            await self.store.ltrim(key, -2 * MAX_TURNS, -1)
            await self.store.expire(key, SESSION_CONVO_TTL_S)
        except Exception as e:  # the reply stands; the turn's record is lost
            print(f"[llm-serve] recording a turn failed: {type(e).__name__}: {e}", flush=True)

    async def h_generate(self, req: Request) -> Response:
        """Raw completion endpoint (no conversation memory)."""
        self.requests_total += 1
        err = await self._ensure_engine()
        if err is not None:
            return err
        try:
            body = req.json()
        except ValueError:
            return Response(400, {"error": "invalid JSON"})
        if not isinstance(body, dict):
            return Response(400, {"error": "invalid JSON"})
        result = await self.engine.generate(
            prompt=str(body.get("prompt", "")),
            max_tokens=int(body.get("max_tokens", 64)),
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            request_id=req.headers.get(REQUEST_ID_HEADER.lower(), ""),
            **self._deadline_from(req),
        )
        return Response(200, result)

    async def h_history(self, req: Request) -> Response:
        self.requests_total += 1
        turns = []
        try:
            keys = [self.convo_key] + sorted(await self.store.keys(f"{self.convo_key}:*"))
        except Exception:
            keys = [self.convo_key]
        for key in keys:
            try:
                raw = await self.store.lrange(key, 0, -1)
            except Exception:
                continue
            for item in raw:
                try:
                    turns.append(json.loads(item))
                except json.JSONDecodeError:
                    continue
        turns.sort(key=lambda t: t.get("ts", 0.0))
        return Response(200, {"history": turns, "count": len(turns)})

    async def h_clear(self, req: Request) -> Response:
        self.requests_total += 1
        try:
            await self.store.delete(self.convo_key)
            for key in await self.store.keys(f"{self.convo_key}:*"):
                await self.store.delete(key)
            # the KV snapshots go too, or a crash-resume would bring back
            # the conversation the user asked to forget
            for key in await self.store.keys(f"agent:{self.agent_id}:kvcache:*"):
                await self.store.delete(key)
        except Exception:
            pass
        if self.engine is not None:
            await asyncio.to_thread(self.engine.clear_sessions, f"{self.agent_id}::")
        return Response(200, {"status": "cleared"})

    async def h_cancel(self, req: Request) -> Response:
        """Abort a request by id: queued work fails before prefill, an
        in-flight lane is parked and its slot freed. ``cancelled`` is False
        for an id already completed."""
        self.requests_total += 1
        err = await self._ensure_engine()
        if err is not None:
            return err
        try:
            body = req.json()
        except ValueError:
            return Response(400, {"error": "invalid JSON"})
        rid = str(body.get("request_id", "")) if isinstance(body, dict) else ""
        if not rid:
            return Response(400, {"error": "request_id required"})
        return Response(200, {"cancelled": bool(self.engine.cancel(rid))})

    async def h_profile(self, req: Request) -> Response:
        """Record a ``torch.profiler`` trace of live serving for
        ``duration_s`` (default 2, at most 25: below the control plane's
        dispatch timeout; ``LLMEngine.profile``): the card's kernels (CUDA
        activity) and the CPU's operators, written as a Chrome trace file into
        ``AGENTAINER_PROFILE_DIR`` (else ``/tmp/atpu-profile-{agent_id}``).
        One capture at a time (409); a duration that is not a number is a
        400."""
        self.requests_total += 1
        err = await self._ensure_engine()
        if err is not None:
            return err
        try:
            body = req.json()
        except ValueError:
            body = {}  # an empty or absent body takes the defaults
        if not isinstance(body, dict):
            body = {}
        try:
            duration = min(float(body.get("duration_s", 2.0) or 2.0), 25.0)
        except (TypeError, ValueError):
            return Response(400, {"error": 'duration_s must be a number, e.g. {"duration_s": 2.0}'})
        if self._profiling:
            return Response(409, {"error": "profile already running"})
        trace_dir = self._env.get("AGENTAINER_PROFILE_DIR", "") or (
            self._host._env.get("AGENTAINER_PROFILE_DIR", "") if self._host is not None else ""
        ) or os.path.join(
            "/tmp", f"atpu-profile-{self.agent_id}"
        )
        os.makedirs(trace_dir, exist_ok=True)
        self._profiling = True
        try:
            # the engine's worker starts and stops the profiler between
            # its dispatches; the export runs off the event loop
            prof = await self.engine.profile(duration)
            path = os.path.join(trace_dir, f"trace-{time.time_ns()}.json")
            await asyncio.to_thread(prof.export_chrome_trace, path)
        except Exception as e:
            return Response(500, {"error": f"profiler failed: {type(e).__name__}: {e}"})
        finally:
            self._profiling = False
        return Response(200, {"trace_dir": trace_dir, "duration_s": duration, "agent_id": self.agent_id})

    async def _hint_session(self, req: Request) -> tuple[str | None, Response | None]:
        """The session a /park or /prewarm body names (default "default"),
        or the answer for a body that is not JSON or an engine not up."""
        self.requests_total += 1
        err = await self._ensure_engine()
        if err is not None:
            return None, err
        try:
            body = req.json()
        except ValueError:
            return None, Response(400, {"error": "invalid JSON"})
        if not isinstance(body, dict):
            body = {}
        return str(body.get("session", "default")), None

    async def h_park(self, req: Request) -> Response:
        """Tiering hint: demote an idle session off the device into the
        engine's host tier; with a store connected the exact blob is also
        written there (the cold tier). The answer carries its size."""
        session, err = await self._hint_session(req)
        if err is not None:
            return err
        if not getattr(self.engine, "kv_tiering", False):
            return Response(200, {"parked": False, "reason": "tiering off"})
        try:
            blob = await self.engine.park_session(self._sess(session))
        except Exception as e:
            self.kv_park_errors += 1
            return Response(200, {"parked": False, "reason": f"{type(e).__name__}: {e}"})
        if blob is None:
            return Response(200, {"parked": False, "reason": "unknown or busy"})
        self.kv_parks += 1
        if self.store.connected:
            # the cold tier: the exact staged blob survives both the host
            # tier's budget and the process
            try:
                await self.store.set_bytes(self._kv_key(session), blob, ttl=KV_SNAPSHOT_TTL_S)
                self._kv_last_snap[session] = time.monotonic()
            except Exception as e:  # the host tier still holds it
                self.kv_park_errors += 1
                print(f"[llm-serve] park store write failed: {type(e).__name__}: {e}", flush=True)
        return Response(200, {"parked": True, "bytes": len(blob)})

    async def h_prewarm(self, req: Request) -> Response:
        """Tiering hint: promote a parked session onto the device ahead of
        its next turn, from the host tier, else from the store's blob (best
        effort: a turn promotes it anyway)."""
        session, err = await self._hint_session(req)
        if err is not None:
            return err
        if not getattr(self.engine, "kv_tiering", False):
            return Response(200, {"prewarmed": False, "reason": "tiering off"})
        ok = False
        try:
            ok = bool(await self.engine.prewarm_session(self._sess(session)))
        except Exception:
            self.kv_prewarm_errors += 1
        if not ok and self.store.connected:
            # the host tier dropped it (or never held it): the store's blob
            # restores the exact context instead
            ok = await self._restore_from_store(session)
        if ok:
            self.kv_prewarms += 1
        return Response(200, {"prewarmed": ok})

    async def h_metrics(self, req: Request) -> Response:
        doc = {
            "engine": "llm",
            "model": self.config_name,
            "replica": self.replica,
            "requests_total": self.requests_total,
            "uptime_s": time.time() - self.started_at,
            "model_loaded": self.engine is not None,
            "engine_error": self.engine_error or None,
            "unhandled_errors": self.unhandled_errors,
            "last_unhandled_error": self.last_unhandled_error or None,
            "kv_snapshots": self.kv_snapshots,
            "kv_snapshots_deferred": self.kv_snapshots_deferred,
            "kv_snapshot_errors": self.kv_snapshot_errors,
            "last_kv_snapshot_error": self.last_kv_snapshot_error or None,
            "last_kv_snapshot": self.last_kv_snapshot,
            "kv_snapshots_in_flight": len(self._snap_tasks),
            "kv_restores": self.kv_restores,
            "last_kv_restore": self.last_kv_restore,
            "prefix_prewarms": self.prefix_prewarms,
            "kv_parks": self.kv_parks,
            "kv_park_errors": self.kv_park_errors,
            "kv_prewarms": self.kv_prewarms,
            "kv_prewarm_errors": self.kv_prewarm_errors,
            "drain_budget_s": self.drain_budget_s,
            "drained_clean": self.drained_clean,
            "drain_snapshots": self.drain_snapshots,
            "flatten_history": self.flatten_history,
            "streams_started": self.streams_started,
            "stream_tokens_emitted": self.stream_tokens_emitted,
            "stream_heartbeats": self.stream_heartbeats,
            "stream_client_disconnects": self.stream_client_disconnects,
        }
        if self._host is not None or self._tenants:
            # one weight copy serves every attached agent: the engine's
            # byte counts below are that one copy
            doc["weights_shared"] = True
            doc["tenants"] = len(self._host._tenants if self._host is not None else self._tenants)
        if self.engine is not None:
            doc.update(self.engine.metrics())
        return Response(200, doc)


def serve() -> None:
    """Process entry point: serve on 127.0.0.1:$AGENTAINER_PORT until
    SIGTERM/SIGINT."""
    app = LLMServeApp()
    port = int(os.environ.get("AGENTAINER_PORT", "8000"))

    async def main() -> None:
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, app.stop)
        await app.run("127.0.0.1", port)

    asyncio.run(main())


if __name__ == "__main__":
    serve()
