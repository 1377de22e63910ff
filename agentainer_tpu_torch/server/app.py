"""Control-plane HTTP server: management REST API + per-agent reverse proxy.

Reference: ``agentainer_tpu/server/app.py`` — the same routes, envelopes and
proxy semantics, on the port's standard-library HTTP (``utils/http``; the
machine with the card has no aiohttp):

- one port serves a public ``/health``, the **unauthenticated** proxy under
  ``/agent/{id}/...``, and a bearer-token-authed management surface under
  ``/agents/*`` plus metrics/logs/audit/slice/faults, the model artifacts
  (``/artifacts``, ``manager/artifacts.py``) and the backups
  (``/backups``, ``manager/backup.py``); ``/internal/store``
  and ``/internal/engines/ready`` authenticate each engine's own token;
- every response uses the ``{success, message, data}`` envelope; a typed
  ``AgentainerError`` answers its status, an unknown route aiohttp's plain
  ``404: Not Found``;
- the proxy journals each request before dispatch (behind the store
  circuit breaker, after the overload shedding check: 429 +
  ``Retry-After``), answers ``202`` with a request id when the agent is not
  running, strips ``/agent/{id}`` from the path, and classifies outcomes as
  the reference does: success → archived response; connection refused,
  engine loading or draining → left pending for the replay worker; timeout
  or protocol error → retry-counted; engine-side expiry → dead-lettered; a
  poisoned prefill → poison-counted. A client that hangs up mid-dispatch
  has its journal entry expired and its engine request cancelled
  (``_abort_dispatch``);
- replayed requests carry ``X-Agentainer-Request-ID`` + ``X-Agentainer-
  Replay: true`` and are not re-journaled; the proxy strips both headers
  from the network.

The replica fleet: an agent with more than one replica is dispatched
through the routing tier (``server/router.py``: health exclusion, per-
replica breakers, session affinity, power-of-two choices), and a
connection-level failure is retried on the next replica, bounded by
``fleet.retry_next_replica``. A ``stream: true`` chat (``features.
streaming``) rides the journaled SSE cursor (``_proxy_stream``): every
token offset is checkpointed in the journal before its frame is written,
and a leg whose upstream dies mid-stream is followed by another — on a
survivor, or on the respawned single replica — that carries the cursor as
``Last-Event-ID``, so the client sees one gapless stream on one connection.

Behind the C++ front door (``runtime/dataplane.py``, the daemon's default
over the native store) this server listens on a loopback port: the C++
journals, dispatches and settles a single-replica agent's ``/agent/*``
itself, so no request it journaled reaches the proxy here; what it
forwards — the management API, and the untouched ``/agent/*`` of a
replica fleet, whose route the daemon leaves to Python — is served and
journaled here as from any client. The C++ reads every answer whole
before it relays it (a log follow excepted), so through it a stream
arrives buffered.

A deploy may name a registered artifact (``{"artifact": name}`` or
``checkpoint: "artifact://name"``): its directory becomes the model's
checkpoint and the engine defaults to ``llm``; an unknown name answers
404. Artifact builds, backups and restores run off the event loop; a
backup export streams its tar.gz with a length and deletes the file after
sending.
"""

from __future__ import annotations

import asyncio
import base64
import hmac
import json
import os
import random
import re
import time
from typing import TYPE_CHECKING, Awaitable, Callable

from .. import faults
from ..core.errors import AgentainerError, AgentNotFound
from ..core.resilience import CircuitBreaker, retry_after_jitter
from ..core.spec import AgentStatus, HealthCheckConfig, Resources
from ..manager.journal import RequestStatus, StreamGapError
from ..store.schema import Keys
from ..utils import http
from ..utils.http import Headers, Request, Response
from .router import ReplicaChoice, ReplicaRouter

if TYPE_CHECKING:
    from ..daemon import Services

from ..core.protocol import (
    DEADLINE_HEADER,
    DISPATCH_ENGINE_GONE,
    DISPATCH_EXPIRED,
    DISPATCH_FAILED,
    DISPATCH_IN_FLIGHT,
    DRAINING_HEADER,
    EXPIRED_HEADER,
    LAST_EVENT_ID_HEADER,
    LOADING_HEADER,
    PREFILL_POISON_HEADER,
    REPLAY_HEADER,
    REQUEST_ID_HEADER,
    STREAM_CONTENT_TYPE,
    STREAM_EVENT_DONE,
    STREAM_EVENT_ERROR,
    STREAM_EVENT_TOKEN,
)

_STORE_OPS = {
    "get", "set", "set_b64", "get_b64", "delete", "expire", "rpush",
    "lrange", "ltrim", "llen", "hincrby", "hgetall", "keys",
}

_HOP_BY_HOP = {
    "connection", "keep-alive", "proxy-authenticate", "proxy-authorization",
    "te", "trailers", "transfer-encoding", "upgrade", "host", "content-length",
    "content-encoding",
}

Handler = Callable[[Request], Awaitable[Response]]

# a streamed leg with no upstream bytes this long (engines send keep-alive
# heartbeats) is lost: the reference's sock_read
STREAM_READ_S = 90.0


def envelope(data=None, message: str = "", success: bool = True) -> dict:
    return {"success": success, "message": message, "data": data}


def ok(data=None, message: str = "", status: int = 200) -> Response:
    return Response(status, envelope(data, message))


def fail(message: str, status: int = 500, headers: dict[str, str] | None = None) -> Response:
    return Response(status, envelope(None, message, success=False), headers)


def _plain(status: int) -> Response:
    """aiohttp's own answer for a route it has not got."""
    return Response(
        status,
        body=f"{status}: {http.REASONS[status]}".encode(),
        content_type="text/plain; charset=utf-8",
    )


def _relay(status: int, headers: dict, body: bytes, request_id: str = "") -> Response:
    """An engine's answer as the proxy's, hop-by-hop headers dropped."""
    out = {
        k: v for k, v in headers.items()
        if k.lower() not in _HOP_BY_HOP and k.lower() != "content-type"
    }
    if request_id:
        # span continuity: the journal id IS the trace span
        out[REQUEST_ID_HEADER] = request_id
    ctype = Headers(headers).get("Content-Type", "application/octet-stream").split(";")[0]
    return Response(status, headers=out, body=body, content_type=ctype)


class _StreamClientGone(Exception):
    """The SSE consumer went away mid-stream. Its own type on purpose: a
    connection error on the client's side aborts the request, one on the
    engine's side fails over to another leg."""


def _parse_sse_frame(raw: bytes) -> tuple[str, int | None, bytes]:
    """One ``\\n\\n``-delimited SSE block → (event, id, data). A pure
    comment block (keep-alive heartbeat) parses as event ``""``."""
    event, eid, data = "", None, b""
    comment = True
    for ln in raw.split(b"\n"):
        if ln.startswith(b":") or not ln.strip():
            continue
        comment = False
        if ln.startswith(b"event:"):
            event = ln[6:].strip().decode("utf-8", "replace")
        elif ln.startswith(b"id:"):
            try:
                eid = int(ln[3:].strip())
            except (TypeError, ValueError):
                eid = None
        elif ln.startswith(b"data:"):
            data = ln[5:].strip()
    return ("" if comment else (event or "message")), eid, data


def _tail_snapshot(path: str, tail: int) -> tuple[list[bytes], int]:
    """Last ``tail`` complete lines of ``path`` plus the follow offset, from
    one read (a trailing partial line is left for the follow loop)."""
    size = os.path.getsize(path)
    window = 256 << 10
    with open(path, "rb") as f:
        while True:
            start = max(0, size - window)
            f.seek(start)
            data = f.read(size - start)
            lines = data.split(b"\n")
            if data.endswith(b"\n"):
                lines.pop()
                offset = start + len(data)
            else:
                partial = lines.pop()
                offset = start + len(data) - len(partial)
            if start > 0:
                lines = lines[1:]  # first piece may be a mid-line fragment
            if start == 0 or len(lines) >= tail:
                return (lines[-tail:] if tail > 0 else []), offset
            window *= 4


class ControlPlaneApp:
    # an engine's KV snapshot reaches /internal/store as base64 JSON: tens
    # of MB for a long session at 8B width
    max_body = 512 << 20

    def __init__(self, services: "Services"):
        self.s = services
        self._routes: list[tuple[str, re.Pattern, Handler]] = []
        self._add_routes()
        # global pending depth is a store SCAN — cached briefly so the shed
        # check stays O(1) per proxied request
        self._global_pending_cache: tuple[float, int] = (0.0, 0)
        # store circuit breaker: when journaling flaps, the proxy answers
        # fast instead of stacking store timeouts on every request
        res = services.config.resilience
        self._store_breaker = CircuitBreaker(
            failure_threshold=res.breaker_failures, cooldown_s=res.breaker_cooldown_s
        )
        # fleet routing tier: engages only for agents with more than one
        # replica. ATPU_JITTER_SEED pins BOTH the p2c sample sequence and
        # the Retry-After jitter; unset = entropy.
        seed_raw = os.environ.get("ATPU_JITTER_SEED", "")
        self.router = ReplicaRouter(
            services.manager,
            services.config.fleet,
            seed=int(seed_raw) if seed_raw else random.randrange(1 << 30),
        )
        self._retry_rng = random.Random(int(seed_raw)) if seed_raw else random.Random()
        self.journal_errors_total = 0
        self.journal_skipped_total = 0
        self.abort_cancel_errors_total = 0
        # SSE streaming data path (features.streaming): per-event forwards,
        # mid-stream failovers (upstream died → another leg spliced), CAS-
        # suppressed duplicate emissions, and dropped consumers
        self.stream_requests_total = 0
        self.stream_events_total = 0
        self.stream_failovers_total = 0
        self.stream_dup_suppressed_total = 0
        self.stream_client_disconnects_total = 0
        self.stream_write_errors_total = 0
        # tiered-KV proxy policy (features.kv_tiering): park a session after
        # its response settles plus a linger window, prewarm on the next
        # arrival so the engine's swap-in overlaps the queue wait
        self._tier_parked: set[tuple[str, str]] = set()
        self._tier_linger_tasks: dict[tuple[str, str], asyncio.Task] = {}
        self._tier_bg: set[asyncio.Task] = set()
        self.tier_parks_total = 0
        self.tier_park_failures_total = 0
        self.tier_prewarms_total = 0

    # -- routing and middleware ----------------------------------------------
    def _add(self, method: str, pattern: str, handler: Handler) -> None:
        rx = re.sub(r"\{(\w+):([^}]+)\}", r"(?P<\1>\2)", pattern)
        rx = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", rx)
        self._routes.append((method, re.compile(f"^{rx}$"), handler))

    def _add_routes(self) -> None:
        add = self._add
        add("GET", "/health", self.h_server_health)
        add("*", "/agent/{agent_id}/{tail:.*}", self.h_proxy)
        add("*", "/agent/{agent_id}", self.h_proxy)
        add("POST", "/agents", self.h_deploy)
        add("GET", "/agents", self.h_list)
        add("GET", "/agents/{agent_id}", self.h_get)
        add("DELETE", "/agents/{agent_id}", self.h_remove)
        for op in ("start", "stop", "restart", "pause", "resume"):
            add("POST", f"/agents/{{agent_id}}/{op}", self._lifecycle_handler(op))
        add("GET", "/agents/{agent_id}/logs", self.h_logs)
        add("GET", "/agents/{agent_id}/requests", self.h_requests)
        add("POST", "/agents/{agent_id}/requests/{request_id}/replay", self.h_manual_replay)
        add("POST", "/agents/{agent_id}/requests/{request_id}/requeue", self.h_requeue)
        add("POST", "/agents/{agent_id}/profile", self.h_profile)
        add("GET", "/agents/{agent_id}/health", self.h_agent_health)
        add("GET", "/agents/{agent_id}/metrics", self.h_agent_metrics)
        add("GET", "/agents/{agent_id}/metrics/history", self.h_agent_metrics_history)
        add("GET", "/metrics", self.h_all_metrics)
        add("GET", "/logs", self.h_get_logs)
        add("GET", "/audit", self.h_get_audit)
        add("GET", "/slice", self.h_slice)
        add("POST", "/internal/store", self.h_internal_store)
        add("POST", "/internal/engines/ready", self.h_engine_ready)
        # fault-injection plane: guarded by the admin bearer token
        add("GET", "/internal/faults", self.h_faults_get)
        add("POST", "/internal/faults", self.h_faults_post)
        add("POST", "/artifacts", self.h_artifact_build)
        add("GET", "/artifacts", self.h_artifact_list)
        add("DELETE", "/artifacts/{name}", self.h_artifact_remove)
        add("POST", "/backups", self.h_backup_create)
        add("GET", "/backups", self.h_backup_list)
        add("POST", "/backups/{backup_id}/restore", self.h_backup_restore)
        add("POST", "/backups/{backup_id}/export", self.h_backup_export)
        add("DELETE", "/backups/{backup_id}", self.h_backup_delete)

    def _route(self, request: Request) -> Handler | Response:
        allowed = False
        for method, rx, handler in self._routes:
            m = rx.match(request.path)
            if m is None:
                continue
            if method in ("*", request.method) or (method == "GET" and request.method == "HEAD"):
                request.match_info = m.groupdict()
                return handler
            allowed = True
        return _plain(405 if allowed else 404)

    async def handle(self, request: Request) -> Response:
        """Auth, route, error envelope (the reference's middlewares)."""
        try:
            denied = self._auth(request)
            if denied is not None:
                return denied
            handler = self._route(request)
            if isinstance(handler, Response):
                return handler
            return await handler(request)
        except AgentainerError as e:
            return fail(str(e), status=e.http_status)
        except Exception as e:
            self.s.logs.error("api", f"unhandled error on {request.path}: {e!r}")
            return fail(f"internal error: {e}", status=500)

    def _auth(self, request: Request) -> Response | None:
        """Bearer auth on the management surface only; the proxy and
        /health are public, /internal/store and /internal/engines/ready
        check each engine's token in their handlers."""
        path = request.path
        public = (
            path == "/health"
            or path.startswith("/agent/")
            or path == "/internal/store"
            or path == "/internal/engines/ready"
        )
        if public:
            return None
        header = request.headers.get("Authorization", "")
        token = header.removeprefix("Bearer ").strip()
        if not header.startswith("Bearer ") or not hmac.compare_digest(
            token.encode(), self.s.config.auth_token.encode()
        ):
            self.s.logs.audit(
                user="unknown",
                action="auth",
                resource=path,
                result="denied",
                ip=request.remote,
                user_agent=request.headers.get("User-Agent", ""),
            )
            return fail("unauthorized", status=401)
        return None

    # -- helpers ---------------------------------------------------------
    def _audit(self, request: Request, action: str, resource: str, result: str) -> None:
        self.s.logs.audit(
            user="api-token",
            action=action,
            resource=resource,
            result=result,
            ip=request.remote,
            user_agent=request.headers.get("User-Agent", ""),
        )

    async def _mgr(self, fn, *args, **kw):
        """Lifecycle ops run in a thread: an engine spawn can block."""
        return await asyncio.to_thread(fn, *args, **kw)

    # -- management handlers ---------------------------------------------
    async def h_server_health(self, request: Request) -> Response:
        return ok(
            {
                "status": "healthy",
                "agents": len(self.s.manager.agent_ids()),
                "slice": self.s.scheduler.topology.name,
                "time": time.time(),
            }
        )

    async def h_deploy(self, request: Request) -> Response:
        try:
            body = json.loads(request.body)
        except ValueError:
            return fail("invalid JSON body", status=400)
        model = body.get("model", body.get("image", "echo"))
        # artifact reference: {"artifact": "name"} or checkpoint
        # "artifact://name" resolves through the registry (manager/artifacts)
        if isinstance(model, dict):
            art_name = model.get("artifact", "") or (
                model.get("checkpoint", "").removeprefix("artifact://")
                if str(model.get("checkpoint", "")).startswith("artifact://")
                else ""
            )
            if art_name:
                doc = self.s.artifacts.get(art_name)
                if doc is None:
                    return fail(f"unknown artifact: {art_name}", status=404)
                model = dict(model)
                model.pop("artifact", None)
                model["checkpoint"] = doc["path"]
                model.setdefault("engine", "llm")
        try:
            replicas = int(body.get("replicas", 0) or 0)
        except (TypeError, ValueError):
            return fail("replicas must be an integer", status=400)
        agent = await self._mgr(
            self.s.manager.deploy,
            name=body.get("name", ""),
            model=model,
            env=body.get("env", {}),
            resources=Resources.from_dict(body.get("resources")),
            auto_restart=bool(body.get("auto_restart", False)),
            token=body.get("token", ""),
            health_check=HealthCheckConfig.from_dict(body.get("health_check")),
            replicas=replicas,
        )
        self._audit(request, "deploy", agent.id, "success")
        return ok(self.s.manager.summary(agent), message="Agent deployed successfully")

    async def h_list(self, request: Request) -> Response:
        agents = await self._mgr(self.s.manager.list_agents)
        return ok([self.s.manager.summary(a) for a in agents])

    async def h_get(self, request: Request) -> Response:
        agent = self.s.manager.get_agent(request.match_info["agent_id"])
        return ok(self.s.manager.summary(agent))

    def _lifecycle_handler(self, op: str) -> Handler:
        async def handler(request: Request) -> Response:
            agent_id = request.match_info["agent_id"]
            agent = await self._mgr(getattr(self.s.manager, op), agent_id)
            if op in ("start", "restart", "resume") and agent.health_check:
                self.s.health.start_monitoring(agent.id)
            if op in ("stop", "pause"):
                self.s.health.stop_monitoring(agent_id)
            self._audit(request, op, agent_id, "success")
            return ok(self.s.manager.summary(agent), message=f"Agent {op} successful")

        return handler

    async def h_remove(self, request: Request) -> Response:
        agent_id = request.match_info["agent_id"]
        self.s.health.stop_monitoring(agent_id)
        await self._mgr(self.s.manager.remove, agent_id)
        self._audit(request, "remove", agent_id, "success")
        return ok(message="Agent removed successfully")

    async def h_logs(self, request: Request) -> Response:
        agent_id = request.match_info["agent_id"]
        tail = int(request.query.get("tail", "100"))
        if request.query.get("follow", "").lower() not in ("", "0", "false"):
            return await self._follow_logs(request, agent_id, tail)
        lines = await self._mgr(self.s.manager.logs, agent_id, tail)
        return ok({"logs": lines})

    async def _follow_logs(self, request: Request, agent_id: str, tail: int) -> Response:
        """Stream engine log lines until the client disconnects (``docker
        logs -f`` parity): the tail and its offset from one read, then
        whatever is appended."""
        path = await self._mgr(self.s.manager.log_path, agent_id)
        out = request.stream
        out.headers = {"Content-Type": "text/plain; charset=utf-8"}
        gone = request.hangup()
        offset = 0
        try:
            if path:
                try:
                    lines, offset = await asyncio.to_thread(_tail_snapshot, path, tail)
                    await out.write(b"".join(line + b"\n" for line in lines))
                except OSError:
                    await out.write(b"")
            else:
                lines = await self._mgr(self.s.manager.logs, agent_id, tail)
                await out.write(b"".join(line.encode() + b"\n" for line in lines))
            while not gone.done():
                if not path:
                    await asyncio.sleep(0.5)
                    path = await self._mgr(self.s.manager.log_path, agent_id)
                    continue
                try:
                    size = os.path.getsize(path)
                except OSError:
                    await asyncio.sleep(0.5)
                    continue
                if size < offset:
                    offset = 0  # rotated/truncated: restart from the top
                if size > offset:
                    with open(path, "rb") as f:
                        f.seek(offset)
                        chunk = f.read(min(size - offset, 1 << 20))
                    offset += len(chunk)
                    await out.write(chunk)
                else:
                    await asyncio.sleep(0.5)  # idle only when caught up
        except Exception:
            pass  # client gone / agent removed: close the stream cleanly
        finally:
            gone.cancel()
        return http.STREAMED

    async def h_requests(self, request: Request) -> Response:
        agent_id = request.match_info["agent_id"]
        self.s.manager.get_agent(agent_id)  # 404 check
        status = request.query.get("status", RequestStatus.PENDING)
        reqs = self.s.journal.by_status(agent_id, status)
        return ok({"requests": [r.to_dict() for r in reqs], "stats": self.s.journal.stats(agent_id)})

    async def h_manual_replay(self, request: Request) -> Response:
        """Manual single-request replay."""
        agent_id = request.match_info["agent_id"]
        request_id = request.match_info["request_id"]
        req = self.s.journal.get(agent_id, request_id)
        if req is None:
            return fail("request not found", status=404)
        if req.expired() or req.status == RequestStatus.EXPIRED:
            return fail(
                "request deadline has passed; use requeue to reset and replay", status=410
            )
        # force: a manual replay re-dispatches settled entries (the engine's
        # idempotency memo returns the stored result)
        status, _, body = await self.dispatch_to_agent(
            agent_id, req.method, req.path, req.headers, req.body,
            request_id=request_id, force=True,
        )
        if status == DISPATCH_ENGINE_GONE:
            self._audit(request, "replay", f"{agent_id}/{request_id}", "engine-unreachable")
            return fail("agent unreachable; request left pending for replay", status=502)
        if status == DISPATCH_FAILED:
            self._audit(request, "replay", f"{agent_id}/{request_id}", "failed")
            return fail("replay dispatch failed; retry recorded", status=504)
        self._audit(request, "replay", f"{agent_id}/{request_id}", "success")
        return ok(
            {"request_id": request_id, "status_code": status, "body": body.decode("utf-8", "replace")},
            message="Request replayed",
        )

    async def h_requeue(self, request: Request) -> Response:
        """Operator recovery for dead letters: a failed/expired entry goes
        back to pending and the replay worker is kicked."""
        agent_id = request.match_info["agent_id"]
        request_id = request.match_info["request_id"]
        self.s.manager.get_agent(agent_id)  # 404 check
        req = self.s.journal.requeue(agent_id, request_id)
        if req is None:
            existing = self.s.journal.get(agent_id, request_id)
            if existing is None:
                return fail("request not found", status=404)
            return fail(
                f"request is {existing.status}; only failed/expired entries requeue", status=409
            )
        if self.s.replay is not None:
            self.s.replay.kick()
        self._audit(request, "requeue", f"{agent_id}/{request_id}", "success")
        return ok(req.to_dict(), message="Request requeued for replay")

    async def h_profile(self, request: Request) -> Response:
        """Record a ``torch.profiler`` trace on the agent's engine (body:
        ``{"duration_s": N}``); the answer carries the trace directory."""
        agent_id = request.match_info["agent_id"]
        try:
            agent = self.s.manager.get_agent(agent_id)
        except AgentNotFound:
            return fail(f"agent not found: {agent_id}", status=404)
        if agent.status != AgentStatus.RUNNING:
            return fail("agent is not running", status=409)
        status, _, resp_body = await self.dispatch_to_agent(
            agent_id, "POST", "/profile", {"Content-Type": "application/json"}, request.body
        )
        if status in (DISPATCH_ENGINE_GONE, DISPATCH_FAILED):
            return fail("engine unreachable for profiling", status=502)
        self._audit(request, "profile", agent_id, "success" if status == 200 else "failed")
        try:
            doc = json.loads(resp_body)
        except ValueError:
            doc = {"raw": resp_body.decode("utf-8", "replace")}
        return ok(doc) if status == 200 else fail(str(doc), status=status)

    async def h_agent_health(self, request: Request) -> Response:
        agent_id = request.match_info["agent_id"]
        self.s.manager.get_agent(agent_id)
        return ok(self.s.health.get_status(agent_id))

    def _fleet_stats(self, agent) -> dict | None:
        """Routing and per-replica breaker view for a multi-replica agent;
        None for a single-replica agent (its metrics keep their shape)."""
        if len(agent.all_engine_ids()) <= 1:
            return None
        return self.router.stats(agent)

    async def h_agent_metrics(self, request: Request) -> Response:
        agent_id = request.match_info["agent_id"]
        agent = self.s.manager.get_agent(agent_id)
        doc = self.s.metrics.current(agent_id) or {}
        fleet = self._fleet_stats(agent)
        if fleet is not None:
            doc = dict(doc)
            doc["fleet"] = fleet
        return ok(doc)

    async def h_agent_metrics_history(self, request: Request) -> Response:
        agent_id = request.match_info["agent_id"]
        self.s.manager.get_agent(agent_id)
        since = float(request.query.get("since", time.time() - 3600))
        until = float(request.query.get("until", time.time()))
        return ok(self.s.metrics.history(agent_id, since, until))

    async def h_all_metrics(self, request: Request) -> Response:
        out = {}
        for agent_id in self.s.manager.agent_ids():
            doc = self.s.metrics.current(agent_id)
            agent = self.s.manager.try_get(agent_id)
            fleet = self._fleet_stats(agent) if agent is not None else None
            if fleet is not None:
                doc = dict(doc or {})
                doc["fleet"] = fleet
            out[agent_id] = doc
        return ok(out)

    async def h_get_logs(self, request: Request) -> Response:
        q = request.query
        if q.get("follow", "").lower() not in ("", "0", "false"):
            return await self._follow_server_logs(
                request,
                tail=int(q.get("limit", "20")),
                level=q.get("level", ""),
                component=q.get("component", ""),
            )
        return ok(
            self.s.logs.get_logs(
                level=q.get("level", ""),
                component=q.get("component", ""),
                agent_id=q.get("agent", ""),
                limit=int(q.get("limit", "100")),
            )
        )

    async def _follow_server_logs(
        self, request: Request, tail: int, level: str = "", component: str = ""
    ) -> Response:
        """Stream the control plane's structured log as JSON lines: a tail
        of recent entries, then live ones from the ``logs:stream`` channel
        until the client disconnects (filters apply to both)."""

        def matches(entry: dict) -> bool:
            if level and entry.get("level") != level:
                return False
            return not (component and entry.get("component") != component)

        out = request.stream
        out.headers = {"Content-Type": "application/x-ndjson; charset=utf-8"}
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue[str] = asyncio.Queue(maxsize=1000)

        def on_entry(_channel: str, message: str) -> None:
            # publisher thread → loop; drop on overflow
            def put():
                if not queue.full():
                    queue.put_nowait(message)

            loop.call_soon_threadsafe(put)

        unsubscribe = None
        gone = request.hangup()
        try:
            entries = self.s.logs.get_logs(level=level, component=component, limit=tail)
            await out.write(b"".join(json.dumps(e).encode() + b"\n" for e in entries))
            unsubscribe = self.s.store.on_message(Keys.LOG_STREAM, on_entry)
            while True:
                getter = asyncio.ensure_future(queue.get())
                done, _ = await asyncio.wait({getter, gone}, return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:
                    getter.cancel()
                    break
                line = getter.result()
                try:
                    if not matches(json.loads(line)):
                        continue
                except ValueError:
                    pass
                await out.write(line.encode() + b"\n")
        except ConnectionError:
            pass
        finally:
            gone.cancel()
            if unsubscribe is not None:
                unsubscribe()
        return http.STREAMED

    async def h_get_audit(self, request: Request) -> Response:
        q = request.query
        return ok(
            self.s.logs.get_audit(
                user=q.get("user", ""),
                action=q.get("action", ""),
                resource=q.get("resource", ""),
                limit=int(q.get("limit", "100")),
            )
        )

    async def h_slice(self, request: Request) -> Response:
        topo = self.s.scheduler.topology
        return ok(
            {
                "topology": {
                    "name": topo.name,
                    "total_chips": topo.total_chips,
                    "hbm_per_chip": topo.hbm_per_chip,
                },
                "placements": [p.to_dict() for p in self.s.scheduler.placements()],
                "free_hbm": self.s.scheduler.free_hbm(),
            }
        )

    # -- model artifacts ---------------------------------------------------
    async def h_artifact_build(self, request: Request) -> Response:
        try:
            body = json.loads(request.body)
        except ValueError:
            return fail("invalid JSON body", status=400)
        path = str(body.get("path", ""))
        if not path:
            return fail("'path' is required", status=400)
        doc = await asyncio.to_thread(self.s.artifacts.build, path, str(body.get("name", "")))
        self._audit(request, "artifact-build", doc["name"], "success")
        return ok(doc, message="Artifact registered")

    async def h_artifact_list(self, request: Request) -> Response:
        return ok(await asyncio.to_thread(self.s.artifacts.list))

    async def h_artifact_remove(self, request: Request) -> Response:
        name = request.match_info["name"]
        removed = await asyncio.to_thread(self.s.artifacts.remove, name)
        if not removed:
            return fail(f"unknown artifact: {name}", status=404)
        self._audit(request, "artifact-remove", name, "success")
        return ok(message="Artifact removed")

    # -- backups -----------------------------------------------------------
    async def h_backup_create(self, request: Request) -> Response:
        try:
            body = json.loads(request.body)
        except ValueError:
            body = {}
        backup = await self._mgr(self.s.backups.create, body.get("name", ""), body.get("description", ""))
        self._audit(request, "backup-create", backup["id"], "success")
        return ok(backup, message="Backup created")

    async def h_backup_list(self, request: Request) -> Response:
        return ok(await self._mgr(self.s.backups.list))

    async def h_backup_restore(self, request: Request) -> Response:
        backup_id = request.match_info["backup_id"]
        restored = await self._mgr(self.s.backups.restore, backup_id)
        self._audit(request, "backup-restore", backup_id, "success")
        return ok(restored, message="Backup restored")

    async def h_backup_export(self, request: Request) -> Response:
        """Bundle one backup into a portable tar.gz and stream its bytes to
        the caller: the archive lands on the client's machine, and the
        daemon never writes a path the client chose. The one-shot file is
        deleted after sending (ones a lost client left are swept by
        ``BackupManager.export``)."""
        backup_id = request.match_info["backup_id"]
        exported = await self._mgr(self.s.backups.export, backup_id)
        try:
            self._audit(request, "backup-export", backup_id, "success")
            out = request.stream
            out.chunked = False  # a length instead: the body ends with the file
            out.headers = {
                "Content-Type": "application/gzip",
                "Content-Disposition": f'attachment; filename="{backup_id}.tar.gz"',
                "Content-Length": str(exported.stat().st_size),
            }
            with exported.open("rb") as f:
                while chunk := await asyncio.to_thread(f.read, 1 << 20):
                    await out.write(chunk)
        finally:
            exported.unlink(missing_ok=True)
        return http.STREAMED

    async def h_backup_delete(self, request: Request) -> Response:
        backup_id = request.match_info["backup_id"]
        await self._mgr(self.s.backups.delete, backup_id)
        self._audit(request, "backup-delete", backup_id, "success")
        return ok(message="Backup deleted")

    def _check_engine_auth(self, request: Request) -> str | None:
        """Validate a per-engine credential; returns the agent id or None."""
        agent_id = request.headers.get("X-Agentainer-Agent-ID", "")
        presented = request.headers.get("Authorization", "").removeprefix("Bearer ").strip()
        expected = self.s.store.get(Keys.internal_token(agent_id)) if agent_id else None
        if not agent_id or expected is None or not hmac.compare_digest(presented.encode(), expected):
            return None
        return agent_id

    async def h_engine_ready(self, request: Request) -> Response:
        """Engine → control plane: "my model finished loading, serve me" —
        the replay drain runs now instead of on the next scan tick."""
        agent_id = self._check_engine_auth(request)
        if agent_id is None:
            return fail("invalid engine credentials", status=401)
        if self.s.quick_sync is not None:
            # refresh the record first so the replay pass sees RUNNING
            await asyncio.to_thread(self.s.quick_sync.sync_agent, agent_id)
        if self.s.replay is not None:
            self.s.replay.kick()
        self.s.logs.info("engine", f"agent {agent_id} reports model ready")
        return ok({"kicked": True})

    # -- fault-injection plane ---------------------------------------------
    async def h_faults_get(self, request: Request) -> Response:
        monitor, repair = self.s.replica_monitor, self.s.fleet_repair
        return ok(
            {
                "active": faults.active(),
                "store_breaker": self._store_breaker.stats(),
                "journal_errors_total": self.journal_errors_total,
                "journal_skipped_total": self.journal_skipped_total,
                "abort_cancel_errors_total": self.abort_cancel_errors_total,
                "tier_parks_total": self.tier_parks_total,
                "tier_park_failures_total": self.tier_park_failures_total,
                "tier_prewarms_total": self.tier_prewarms_total,
                "tier_parked_sessions": len(self._tier_parked),
                "stream_requests_total": self.stream_requests_total,
                "stream_events_total": self.stream_events_total,
                "stream_failovers_total": self.stream_failovers_total,
                "stream_dup_suppressed_total": self.stream_dup_suppressed_total,
                "stream_client_disconnects_total": self.stream_client_disconnects_total,
                "stream_write_errors_total": self.stream_write_errors_total,
                # the fleet plane: lease refreshes, SUSPECT and DEAD
                # transitions, repairs and the work they reassigned
                "replica_monitor": monitor.stats() if monitor is not None else None,
                "fleet_repair": None if repair is None else {
                    "repairs_total": repair.repairs_total,
                    "reassigned_total": repair.reassigned_total,
                    "respawn_errors_total": repair.respawn_errors_total,
                },
            }
        )

    async def h_faults_post(self, request: Request) -> Response:
        """Arm/disarm failpoints at runtime (admin bearer token): ``{"arm":
        spec string or [{name, ...}]}``, ``{"disarm": [names]}``,
        ``{"disarm_all": true}``; disarms apply first."""
        try:
            body = json.loads(request.body)
        except ValueError:
            return fail("invalid JSON body", status=400)
        armed: list[str] = []
        disarmed: list[str] = []
        try:
            if body.get("disarm_all"):
                disarmed = [fp["name"] for fp in faults.active()]
                faults.disarm_all()
            for name in body.get("disarm", []) or []:
                if faults.disarm(str(name)):
                    disarmed.append(str(name))
            spec = body.get("arm")
            if isinstance(spec, str) and spec:
                armed += faults.arm_spec(spec)
            elif isinstance(spec, list):
                for kw in spec:
                    if not isinstance(kw, dict) or "name" not in kw:
                        return fail("each arm entry needs a 'name'", status=400)
                    faults.arm(**kw)
                    armed.append(kw["name"])
        except (TypeError, ValueError) as e:
            return fail(f"bad failpoint spec: {e}", status=400)
        self._audit(
            request,
            "faults",
            f"arm={','.join(armed) or '-'} disarm={','.join(disarmed) or '-'}",
            "success",
        )
        return ok({"armed": armed, "disarmed": disarmed, "active": faults.active()})

    # -- internal store API for engine processes ---------------------------
    async def h_internal_store(self, request: Request) -> Response:
        """Store access for engine processes, each with its own per-engine
        token (never the admin token) and namespaced to ``agent:{id}:*``."""
        try:
            body = json.loads(request.body)
        except ValueError:
            return fail("invalid JSON", status=400)
        agent_id = self._check_engine_auth(request)
        if agent_id is None:
            return fail("invalid engine credentials", status=401)
        store = self.s.store
        ns = f"agent:{agent_id}:"
        if body.get("op") == "pipeline":
            # one round-trip for a batch; validated whole before any op runs
            ops = body.get("ops")
            if not isinstance(ops, list) or not all(isinstance(o, dict) for o in ops):
                return fail("pipeline ops must be a list of objects", status=400)
            for sub in ops:
                if not str(sub.get("key", "")).startswith(ns):
                    return fail("key outside agent namespace", status=403)
                if sub.get("op") not in _STORE_OPS:
                    return fail(f"unknown op {sub.get('op')!r}", status=400)
                pat = sub.get("pattern")
                if pat is not None and not str(pat).startswith(ns):
                    return fail("pattern outside agent namespace", status=403)
            try:
                return ok([self._store_op(store, ns, sub) for sub in ops])
            except (TypeError, ValueError) as e:
                return fail(str(e), status=400)
        op = body.get("op", "")
        key = body.get("key", "")
        if not key.startswith(ns):
            return fail("key outside agent namespace", status=403)
        if op == "keys" and not str(body.get("pattern", key + "*")).startswith(ns):
            return fail("pattern outside agent namespace", status=403)
        try:
            return ok(self._store_op(store, ns, body))
        except (TypeError, ValueError) as e:
            return fail(str(e), status=400)

    @staticmethod
    def _store_op(store, ns: str, body: dict):
        """Execute one namespace-checked store op; raises ValueError on bad
        input."""
        op = body.get("op", "")
        key = body.get("key", "")
        if op == "get":
            raw = store.get(key)
            return None if raw is None else raw.decode("utf-8", "replace")
        if op == "set":
            store.set(key, body.get("value", ""), ttl=body.get("ttl"))
            return None
        if op == "set_b64":
            store.set(key, base64.b64decode(body.get("value_b64", "")), ttl=body.get("ttl"))
            return None
        if op == "get_b64":
            raw = store.get(key)
            return None if raw is None else base64.b64encode(raw).decode()
        if op == "delete":
            return store.delete(key)
        if op == "expire":
            return int(store.expire(key, float(body.get("ttl", 0))))
        if op == "rpush":
            return store.rpush(key, *list(body.get("values", [])))
        if op == "lrange":
            return store.lrange_str(key, body.get("start", 0), body.get("stop", -1))
        if op == "ltrim":
            store.ltrim(key, body.get("start", 0), body.get("stop", -1))
            return None
        if op == "llen":
            return store.llen(key)
        if op == "hincrby":
            return store.hincrby(key, body.get("field", ""), body.get("amount", 1))
        if op == "hgetall":
            return {k: v.decode("utf-8", "replace") for k, v in store.hgetall(key).items()}
        if op == "keys":
            return store.keys(body.get("pattern", key + "*"))
        raise ValueError(f"unknown op {op!r}")

    # -- the proxy data path -------------------------------------------------
    async def h_proxy(self, request: Request) -> Response:
        agent_id = request.match_info["agent_id"]
        tail = request.match_info.get("tail", "")
        path = "/" + tail if not tail.startswith("/") else tail
        if request.query_string:
            path = f"{path}?{request.query_string}"
        body = request.body
        headers = {k: v for k, v in request.headers.items() if k.lower() not in _HOP_BY_HOP}
        try:
            agent = self.s.manager.get_agent(agent_id)
        except AgentNotFound:
            return fail(f"agent not found: {agent_id}", status=404)
        # replay dispatches in-process: these headers from the network are
        # only attack surface (skip journaling, settle another's entry)
        headers = Headers(headers)
        headers.pop(REPLAY_HEADER, None)
        headers.pop(REQUEST_ID_HEADER, None)
        # a client RECONNECT after a dropped stream carries Last-Event-ID
        # (the highest offset it holds) plus the request id it was issued:
        # the pair re-attaches to the SAME journal entry — no new journal
        # write, no new generation (the engine memo re-emits the sequence;
        # the proxy skips offsets <= the floor). The echoed id only ever
        # splices a stream, never settles an entry or skips journaling.
        stream = self._wants_stream(path, body)
        resume_rid = ""
        if stream and request.headers.get(LAST_EVENT_ID_HEADER, ""):
            resume_rid = request.headers.get(REQUEST_ID_HEADER, "").strip()

        # Per-request deadline: an explicit header always sticks; the config
        # default applies only when the agent is up to serve now (a 202
        # queued request keeps the replay-forever contract)
        dl = self.s.config.deadlines
        deadline_at = None
        if dl.enabled:
            raw = request.headers.get(DEADLINE_HEADER, "")
            ms = 0.0
            if raw:
                try:
                    ms = float(raw)
                except (TypeError, ValueError):
                    ms = 0.0
            elif agent.status == AgentStatus.RUNNING:
                ms = dl.default_ms
            if ms > 0:
                deadline_at = time.time() + ms / 1000.0

        request_id = ""
        persist = self.s.config.features.request_persistence
        if persist:
            if dl.enabled:
                # overload shedding BEFORE journaling
                try:
                    reason = self._shed_reason(agent_id, dl)
                except Exception:
                    # depth accounting is store-backed: admit during a blip
                    self._store_breaker.fail()
                    reason = ""
                if reason:
                    self.s.metrics.count_shed(agent_id)
                    return fail(
                        f"overloaded: {reason}; retry later",
                        status=429,
                        headers={"Retry-After": str(retry_after_jitter(dl.retry_after_s, self._retry_rng))},
                    )
            # journal behind the store circuit breaker: a RUNNING agent
            # still serves without durability when journaling fails; one
            # that is down answers 503 instead of a 202 it cannot honor
            if not self._store_breaker.allow():
                self.journal_skipped_total += 1
            elif resume_rid:
                # stream resume: the entry is journaled under the id the
                # client echoed back — re-journaling would fork it
                request_id = resume_rid
            else:
                try:
                    journaled = self.s.journal.store_request(
                        agent_id, request.method, path, dict(headers), body, deadline_at=deadline_at
                    )
                    self._store_breaker.ok()
                    request_id = journaled.id
                except Exception as e:
                    self._store_breaker.fail()
                    self.journal_errors_total += 1
                    self.journal_skipped_total += 1
                    try:
                        self.s.logs.warn(
                            "proxy",
                            f"journaling failed for {agent_id} "
                            f"({type(e).__name__}: {e}); serving without durability",
                            agent_id=agent_id,
                        )
                    except Exception:
                        pass  # the log plane rides the same store

        if agent.status != AgentStatus.RUNNING:
            if persist and request_id:
                return ok(
                    {"request_id": request_id, "status": "pending"},
                    message="Agent is not running. Request queued and will be "
                    "replayed when the agent is back.",
                    status=202,
                )
            if persist:
                return fail(
                    "store unavailable; request cannot be queued for replay",
                    status=503,
                    headers={
                        "Retry-After": str(
                            retry_after_jitter(self._store_breaker.cooldown_s, self._retry_rng)
                        )
                    },
                )
            return fail("agent is not running", status=503)

        if self._tier_enabled() and path.startswith("/chat"):
            # returning turn: the prewarm hint goes before the chat dispatch
            self._tier_on_arrival(agent_id, self._session_hint(body) or "default")

        if stream:
            return await self._proxy_stream(request, agent, path, headers, body, request_id, deadline_at)

        dispatch = asyncio.ensure_future(
            self.dispatch_to_agent(
                agent_id, request.method, path, headers, body,
                request_id=request_id, deadline_at=deadline_at,
            )
        )
        if dl.enabled:
            # watch the CLIENT while the engine works: a caller that hangs
            # up mid-dispatch has its abort propagated to the engine
            gone = request.hangup()
            try:
                await asyncio.wait({dispatch, gone}, return_when=asyncio.FIRST_COMPLETED)
            finally:
                gone.cancel()
            if not dispatch.done():
                dispatch.cancel()
                await self._abort_dispatch(agent_id, request_id)
                return Response(499, {"error": "client disconnected"})
        status, resp_headers, resp_body = await dispatch
        # error envelopes of journaled dispatches carry the request id
        rid_headers = {REQUEST_ID_HEADER: request_id} if request_id else None
        if status == DISPATCH_ENGINE_GONE:
            return fail("agent unreachable; request left pending for replay", status=502, headers=rid_headers)
        if status == DISPATCH_FAILED:
            return fail("agent request failed; retry recorded", status=504, headers=rid_headers)
        if status == DISPATCH_EXPIRED:
            return fail("deadline exceeded; request dead-lettered", status=504, headers=rid_headers)
        if status == DISPATCH_IN_FLIGHT:
            # a replay tick CAS-claimed the fresh entry first: serve the
            # winner's archived result
            archived = await self._await_archived(agent_id, request_id, deadline_at)
            if archived is not None:
                return archived
            return fail("request already being dispatched", status=409)
        if self._tier_enabled() and status == 200 and path.startswith("/chat"):
            self._tier_schedule_park(agent_id, self._session_hint(body) or "default")
        return _relay(status, resp_headers, resp_body, request_id)

    def _shed_reason(self, agent_id: str, dl) -> str:
        """Why this request should be shed now, or "" to admit: per-agent
        pending depth, the global pending ceiling, the engine's own
        queue+waiting depth from its latest metrics sample."""
        j = self.s.journal
        if dl.shed_pending_per_agent and j.pending_depth(agent_id) >= dl.shed_pending_per_agent:
            # the O(1) llen may count expired entries: sweep and recount
            if len(j.pending(agent_id)) >= dl.shed_pending_per_agent:
                return f"agent pending depth >= {dl.shed_pending_per_agent}"
            self._global_pending_cache = (0.0, 0)
        if dl.shed_pending_global:
            now = time.monotonic()
            expires, total = self._global_pending_cache
            if now >= expires:
                total = j.total_pending()
                self._global_pending_cache = (now + 0.25, total)
            if total >= dl.shed_pending_global:
                return f"global pending depth >= {dl.shed_pending_global}"
        if dl.engine_queue_watermark:
            engine = (self.s.metrics.current(agent_id) or {}).get("engine") or {}
            depth = (engine.get("queue_depth") or 0) + (engine.get("waiting_depth") or 0)
            if depth >= dl.engine_queue_watermark:
                return f"engine queue depth {depth} >= {dl.engine_queue_watermark}"
        return ""

    def _journal_op(self, fn, *args, **kw):
        """Best-effort journal settlement: a store blip mid-settle must not
        turn an already-served response into a 500 (the replay worker's
        staleness reclaim repairs the entry; the engine memo prevents a
        double execution)."""
        try:
            result = fn(*args, **kw)
            self._store_breaker.ok()
            return result
        except Exception as e:
            self._store_breaker.fail()
            self.journal_errors_total += 1
            try:
                self.s.logs.warn(
                    "proxy",
                    f"journal settle {getattr(fn, '__name__', fn)!s} failed: {type(e).__name__}: {e}",
                )
            except Exception:
                pass
            return None

    async def _abort_dispatch(self, agent_id: str, request_id: str) -> None:
        """Client disconnected mid-dispatch: dead-letter the journal entry
        and tell the engine to stop generating for it (best effort)."""
        if request_id:
            self._journal_op(
                self.s.journal.mark_expired, agent_id, request_id, reason="client disconnected"
            )
        try:
            agent = self.s.manager.get_agent(agent_id)
            endpoint = self.s.manager.endpoint(agent)
            if endpoint and request_id:
                await self._cancel_on_engine(endpoint, request_id)
        except Exception as e:
            self.abort_cancel_errors_total += 1
            try:
                self.s.logs.warn(
                    "proxy",
                    f"engine cancel failed for {agent_id}/{request_id}: {type(e).__name__}: {e}",
                )
            except Exception:
                pass
        self.s.logs.info(
            "proxy",
            f"aborted dispatch {request_id or '<unjournaled>'} for {agent_id}: client disconnected",
        )

    async def dispatch_to_agent(
        self,
        agent_id: str,
        method: str,
        path: str,
        headers: dict[str, str],
        body: bytes,
        request_id: str = "",
        deadline_at: float | None = None,
        force: bool = False,
    ) -> tuple[int, dict[str, str], bytes]:
        """Forward to the engine and settle the journal entry.

        Before dispatch the entry's pending→processing transition is
        CLAIMED with a store compare-and-set (of two racing dispatchers
        exactly one wins; the loser returns DISPATCH_IN_FLIGHT; ``force``
        skips the claim). A deadline already passed → DISPATCH_EXPIRED;
        success → COMPLETED with the archived response; connection-level
        failure, loading or draining → back to PENDING, DISPATCH_ENGINE_GONE;
        timeout or protocol error → retry-counted, DISPATCH_FAILED.

        Fleet (the agent has more than one replica): the routing tier picks
        the replica, and a connection-level failure retries on the NEXT
        replica, bounded by ``fleet.retry_next_replica``. The retry forwards
        the SAME claim: nothing executed on the replica that refused, the
        CAS admitted exactly this dispatcher, and the engine memoizes by
        request id — so the retry cannot double-execute. Single-replica
        agents never enter the router."""
        agent = self.s.manager.get_agent(agent_id)
        multi = len(agent.all_engine_ids()) > 1
        session_hint = ""
        if multi:
            # parsed here, not in h_proxy, so every dispatcher (live proxy,
            # replay, manual replay) pins the session to the replica that
            # actually serves it
            session_hint = self._session_hint(body)
            choice = self.router.pick(agent, session=session_hint)
        else:
            endpoint = self.s.manager.endpoint(agent)
            choice = None if endpoint is None else ReplicaChoice(agent.engine_id, endpoint)
        if choice is None:
            return DISPATCH_ENGINE_GONE, {}, b""
        if deadline_at is not None and time.time() > deadline_at:
            if request_id:
                self._journal_op(
                    self.s.journal.mark_expired, agent_id, request_id, reason="deadline exceeded"
                )
            return DISPATCH_EXPIRED, {}, b""
        if request_id:
            if force:
                self._journal_op(self.s.journal.mark_processing, agent_id, request_id)
            else:
                try:
                    claimed = self.s.journal.acquire_processing(
                        agent_id, request_id, replica_id=choice.engine_id
                    )
                except Exception:
                    # can't verify the claim with the store dark: do NOT
                    # forward (durability over latency; no double execution)
                    self._store_breaker.fail()
                    self.journal_errors_total += 1
                    claimed = False
                if not claimed:
                    return DISPATCH_IN_FLIGHT, {}, b""
        tried: set[str] = set()
        attempts = 0
        # bound by ATTEMPTS, not distinct replicas: a stale routing table
        # (router.pick failpoint) can hand the same dead replica back twice
        max_attempts = 1 + (self.router.retry_next_replica if multi else 0)
        while True:
            attempts += 1
            result = await self._dispatch_once(
                agent, choice, multi, method, path, headers, body, request_id, deadline_at
            )
            if result is not None:
                return result
            # connection-level failure (or loading/draining): nothing ran on
            # that replica — eligible for the bounded next-replica retry
            tried.add(choice.engine_id)
            choice = None
            if multi and attempts < max_attempts:
                choice = self.router.pick(agent, session=session_hint, exclude=frozenset(tried))
            if choice is None:
                # every allowed replica refused: the crash heuristic leaves
                # the request pending for the replay worker
                if request_id:
                    self._journal_op(self.s.journal.mark_pending, agent_id, request_id)
                return DISPATCH_ENGINE_GONE, {}, b""
            if request_id and not force:
                # re-attribute the claim to the replica this retry forwards
                # to: fleet repair reassigns by attribution
                self._journal_op(self.s.journal.set_replica, agent_id, request_id, choice.engine_id)

    async def _dispatch_once(
        self, agent, choice: ReplicaChoice, multi: bool, method: str, path: str,
        headers: dict[str, str], body: bytes, request_id: str, deadline_at: float | None,
    ) -> tuple[int, dict[str, str], bytes] | None:
        """One forwarding attempt against one replica: the settled outcome,
        or None for a connection-level failure or a not-admitting 503
        (loading, draining) — nothing executed, nothing settled (the caller
        owns pending versus next replica)."""
        if multi:
            self.router.begin(choice.engine_id)
        answered = False
        try:
            if choice.endpoint.startswith("fake://"):
                result = self._dispatch_fake(agent, choice, method, path, headers, body, request_id)
                answered = result is not None
                return result
            result, answered = await self._dispatch_http(
                agent.id, choice.endpoint, method, path, headers, body, request_id, deadline_at
            )
            return result
        finally:
            if multi:
                # per-replica breaker feed: anything that answered over the
                # socket is proof of life; connection-level failures and
                # timeouts count against THIS replica's breaker only
                self.router.end(choice.engine_id, answered)

    def _dispatch_fake(self, agent, choice, method, path, headers, body, request_id):
        """In-process dispatch for the unit-test backend (the routed
        replica receives the request)."""
        handler = getattr(self.s.backend, "handle_request", None)
        if handler is None:
            return None
        try:
            faults.fire("proxy.dispatch")
            status, resp_headers, resp_body = handler(choice.engine_id, method, path, headers, body)
        except ConnectionError:
            return None
        if request_id:
            self._journal_op(
                self.s.journal.store_response, agent.id, request_id, status, resp_headers, resp_body
            )
        self.s.metrics.count_request(agent.id)
        return status, resp_headers, resp_body

    @staticmethod
    def _session_hint(body: bytes) -> str:
        if not body:
            return ""
        try:
            doc = json.loads(body)
            return str(doc.get("session", "") or "") if isinstance(doc, dict) else ""
        except (ValueError, UnicodeDecodeError):
            return ""

    def _forward_headers(self, headers: dict, request_id: str, deadline_at: float | None) -> Headers:
        fwd = Headers(headers)
        fwd.pop("Authorization", None)
        # the journaled original deadline header never leaks through:
        # deadline_at is authoritative (a requeued entry has it cleared)
        fwd.pop(DEADLINE_HEADER, None)
        if request_id:
            fwd[REQUEST_ID_HEADER] = request_id
        if deadline_at is not None:
            remaining = deadline_at - time.time()
            fwd[DEADLINE_HEADER] = str(max(1, int(remaining * 1000)))
        return fwd

    def _classify(
        self, agent_id: str, request_id: str, status: int, rheaders: Headers, rbody: bytes
    ) -> tuple[tuple[int, dict, bytes] | None, bool]:
        """Settle an engine's answer in the journal as the reference does:
        (outcome, archived). The outcome is None for the retryable
        not-admitting 503 (loading, draining)."""
        if status == 503 and (
            rheaders.get(LOADING_HEADER, "").lower() == "true"
            or rheaders.get(DRAINING_HEADER, "").lower() == "true"
        ):
            return None, False
        if rheaders.get(EXPIRED_HEADER, "").lower() == "true":
            # dropped by the engine's deadline/cancel policy: dead-letter
            if request_id:
                self._journal_op(
                    self.s.journal.mark_expired, agent_id, request_id, reason="expired on engine"
                )
            return (DISPATCH_EXPIRED, {}, b""), False
        if status >= 500 and rheaders.get(PREFILL_POISON_HEADER, "").lower() == "true":
            # the request itself breaks prefill on a healthy engine: poison
            # accounting (two strikes dead-letter it), never archived
            if request_id:
                self._journal_op(
                    self.s.journal.mark_failed, agent_id, request_id,
                    f"prefill poisoned (HTTP {status})", poison=True,
                )
            return (status, rheaders, rbody), False
        if status == 429:
            # engine-side shed: back to pending, no retry charged
            if request_id:
                self._journal_op(self.s.journal.mark_pending, agent_id, request_id)
            return (status, rheaders, rbody), False
        if request_id:
            self._journal_op(
                self.s.journal.store_response, agent_id, request_id, status, dict(rheaders), rbody
            )
        return (status, rheaders, rbody), True

    async def _dispatch_http(
        self,
        agent_id: str,
        endpoint: str,
        method: str,
        path: str,
        headers: dict[str, str],
        body: bytes,
        request_id: str,
        deadline_at: float | None,
    ) -> tuple[tuple[int, dict[str, str], bytes] | None, bool]:
        """The HTTP leg of ``_dispatch_once``: (outcome or None, whether
        the replica answered over the socket)."""
        url = endpoint.rstrip("/") + path
        fwd = self._forward_headers(headers, request_id, deadline_at)
        timeout = 30.0
        if deadline_at is not None:
            # the dispatch wait is clamped to the caller's remaining budget
            timeout = min(30.0, max(0.1, deadline_at - time.time()))
        t0 = time.monotonic()
        try:
            # failpoint: ConnectionError → engine gone, TimeoutError → retry
            # accounting, delay_ms → a slow engine
            await faults.fire_async("proxy.dispatch")
            status, rheaders, rbody = await http.request(method, url, fwd, body, timeout=timeout)
        except (asyncio.TimeoutError, http.ServerDisconnected) as e:
            if deadline_at is not None and time.time() > deadline_at:
                # the wait ran out the caller's budget: dead-letter, cancel
                if request_id:
                    self._journal_op(
                        self.s.journal.mark_expired, agent_id, request_id, reason="deadline exceeded"
                    )
                    await self._cancel_on_engine(endpoint, request_id)
                return (DISPATCH_EXPIRED, {}, b""), False
            if request_id:
                self._journal_op(
                    self.s.journal.mark_failed, agent_id, request_id, f"{type(e).__name__}: {e}"
                )
            return (DISPATCH_FAILED, {}, b""), False
        except OSError:
            # the connection was refused or could not be made: nothing ran
            # here — retryable on another replica, settled by the caller
            return None, False
        result, archived = self._classify(agent_id, request_id, status, rheaders, rbody)
        if archived:
            self.s.metrics.count_request(agent_id, latency_s=time.monotonic() - t0)
        return result, True

    # -- SSE streaming data path (features.streaming) ------------------------
    def _wants_stream(self, path: str, body: bytes) -> bool:
        """Streams only with the feature flag on AND the chat body opting
        in; the buffered path is the default."""
        if not self.s.config.features.streaming or not path.startswith("/chat") or not body:
            return False
        try:
            doc = json.loads(body)
            return bool(doc.get("stream")) if isinstance(doc, dict) else False
        except (ValueError, UnicodeDecodeError):
            return False

    async def _proxy_stream(
        self,
        request: Request,
        agent,
        path: str,
        headers: Headers,
        body: bytes,
        request_id: str,
        deadline_at: float | None,
    ) -> Response:
        """Streamed dispatch: forward the engine's SSE token stream to the
        client, journaling every offset as a streaming checkpoint BEFORE its
        frame goes on the wire (checkpoint-then-emit).

        - **mid-stream upstream death** (the replica's host SIGKILLed, a
          reset, an injected ``proxy.stream_emit`` fault): the cursor names
          the last acked offset; the next leg — on a survivor, or on the
          respawned single replica — carries it as ``Last-Event-ID``; the
          engine restores the session, re-emits its deterministic sequence
          and skips every offset <= the cursor. The client sees ONE gapless,
          duplicate-free sequence on ONE connection;
        - **duplicate emission**: ``journal.advance_stream`` CAS-rejects the
          second advance and the local cursor drops the event;
        - **offset gap**: ``StreamGapError`` — a hard error that truncates
          the stream; a silent skip would corrupt the splice;
        - **client hang-up**: the entry settles EXPIRED at the last acked
          offset and the engine's lane is cancelled;
        - **non-stream upstream outcomes** (loading or draining 503, poisoned
          prefill 500, 429 shed) classify exactly like the buffered path.
        """
        agent_id = agent.id
        self.stream_requests_total += 1
        multi = len(agent.all_engine_ids()) > 1
        session_hint = self._session_hint(body)
        rid_headers = {REQUEST_ID_HEADER: request_id} if request_id else None
        # the client's splice floor: the highest offset it already holds (a
        # reconnect sends its Last-Event-ID; a fresh stream starts at -1)
        floor = -1
        raw_floor = request.headers.get(LAST_EVENT_ID_HEADER, "")
        if raw_floor:
            try:
                floor = int(raw_floor)
            except (TypeError, ValueError):
                floor = -1
        resume = bool(raw_floor)
        if multi:
            choice = self.router.pick(agent, session=session_hint)
        else:
            endpoint = self.s.manager.endpoint(agent)
            choice = None if endpoint is None else ReplicaChoice(agent.engine_id, endpoint)
        if choice is None or not choice.endpoint.startswith("http"):
            return fail("agent unreachable; request left pending for replay", status=502, headers=rid_headers)
        if deadline_at is not None and time.time() > deadline_at:
            if request_id:
                self._journal_op(
                    self.s.journal.mark_expired, agent_id, request_id, reason="deadline exceeded"
                )
            return fail("deadline exceeded; request dead-lettered", status=504, headers=rid_headers)
        if request_id and not resume:
            # the buffered path's CAS claim; a resume re-attaches to an
            # entry that is already PROCESSING or COMPLETED (the engine memo
            # re-emits it), so it skips the claim
            try:
                claimed = self.s.journal.acquire_processing(
                    agent_id, request_id, replica_id=choice.engine_id
                )
            except Exception:
                self._store_breaker.fail()
                self.journal_errors_total += 1
                claimed = False
            if not claimed:
                archived = await self._await_archived(agent_id, request_id, deadline_at)
                return archived or fail("request already being dispatched", status=409)

        out = request.stream
        out.headers = {
            "Content-Type": STREAM_CONTENT_TYPE,
            "Cache-Control": "no-cache",
            "X-Accel-Buffering": "no",
        }
        if request_id:
            # the resume credential: a reconnect echoes this id and its
            # Last-Event-ID to re-splice the same entry
            out.headers[REQUEST_ID_HEADER] = request_id
        cursor = floor
        gone = request.hangup()
        t0 = time.monotonic()

        async def client_write(payload: bytes) -> None:
            try:
                await out.write(payload)
            except ConnectionError as e:
                raise _StreamClientGone() from e

        async def forward_frame(raw: bytes) -> bool:
            """Forward one upstream SSE block; True on the terminal done."""
            nonlocal cursor
            event, eid, data = _parse_sse_frame(raw)
            if event == STREAM_EVENT_TOKEN:
                off = eid if eid is not None else cursor + 1
                if off <= cursor:
                    # duplicate emission (overlapping legs, a memo re-emit
                    # racing the splice): dropped before the wire
                    self.stream_dup_suppressed_total += 1
                    return False
                if off != cursor + 1:
                    raise StreamGapError(
                        f"stream splice gap for {agent_id}/{request_id or '<unjournaled>'}: "
                        f"acked={cursor}, offered={off}"
                    )
                # firing here models a dispatch failure mid-stream: the
                # cursor is NOT advanced, so the next leg re-offers this offset
                await faults.fire_async("proxy.stream_emit")
                if request_id:
                    # checkpoint-then-emit. False = already journaled (a
                    # reconnect re-serving acked events): still owed to THIS
                    # client, whose own floor admitted it
                    try:
                        self.s.journal.advance_stream(agent_id, request_id, off)
                    except StreamGapError:
                        raise
                    except Exception:
                        # a store blip must not kill a live stream
                        self._store_breaker.fail()
                        self.journal_errors_total += 1
                await client_write(raw + b"\n\n")
                cursor = off
                self.stream_events_total += 1
                return False
            if event == STREAM_EVENT_DONE and request_id:
                # the done payload is the entry's completed response, byte
                # for byte what the buffered path would have archived
                self._journal_op(
                    self.s.journal.store_response, agent_id, request_id, 200,
                    {"Content-Type": "application/json"}, bytes(data),
                )
            # keep-alive comments never advance the offset; unknown events
            # are forwarded verbatim
            await client_write(raw + b"\n\n")
            return event == STREAM_EVENT_DONE

        async def one_leg() -> tuple[str, Response | None]:
            fwd = self._forward_headers(headers, request_id, deadline_at)
            fwd.pop(LAST_EVENT_ID_HEADER, None)
            if cursor >= 0:
                # the splice cursor: the engine skips offsets <= this value
                fwd[LAST_EVENT_ID_HEADER] = str(cursor)
            status, rheaders, reader, writer = await http.open_stream(
                request.method, choice.endpoint.rstrip("/") + path, fwd, body
            )
            try:
                if status != 200 or not rheaders.get("Content-Type", "").startswith(STREAM_CONTENT_TYPE):
                    rbody = await asyncio.wait_for(http.read_body(reader, rheaders), STREAM_READ_S)
                    result, _ = self._classify(agent_id, request_id, status, rheaders, rbody)
                    if result is None:
                        return "retry", None
                    if result[0] == DISPATCH_EXPIRED:
                        return "plain", fail("deadline exceeded; request dead-lettered", status=504,
                                             headers=rid_headers)
                    return "plain", _relay(*result, request_id)
                buf = b""
                upstream = http.BodyReader(reader, rheaders)
                while True:
                    chunk = asyncio.ensure_future(upstream.read())
                    finished, _ = await asyncio.wait(
                        {chunk, gone}, timeout=STREAM_READ_S, return_when=asyncio.FIRST_COMPLETED
                    )
                    if chunk not in finished:
                        chunk.cancel()
                        if gone in finished:
                            raise _StreamClientGone()
                        raise asyncio.TimeoutError("no upstream bytes (not even a heartbeat)")
                    data = chunk.result()  # a reset raises: the upstream is lost
                    if not data:
                        # the upstream closed without its done event: a
                        # mid-stream death, never a clean end
                        return "retry", None
                    buf += data
                    while b"\n\n" in buf:
                        frame, buf = buf.split(b"\n\n", 1)
                        if await forward_frame(frame):
                            return "done", None
            finally:
                writer.close()

        tried: set[str] = set()
        attempts = 0
        max_attempts = 1 + (self.router.retry_next_replica if multi else 2)
        try:
            while True:
                attempts += 1
                if multi:
                    self.router.begin(choice.engine_id)
                answered = False
                try:
                    kind, terminal = await one_leg()
                    answered = True
                except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                        http.ServerDisconnected, faults.FaultInjected):
                    kind, terminal = "retry", None
                finally:
                    if multi:
                        self.router.end(choice.engine_id, answered)
                if kind == "done":
                    self.s.metrics.count_request(agent_id, latency_s=time.monotonic() - t0)
                    if self._tier_enabled():
                        self._tier_schedule_park(agent_id, session_hint or "default")
                    return http.STREAMED
                if kind == "plain":
                    if not out.started:
                        return terminal
                    # already streaming and a later leg settled plain:
                    # nothing splice-able is coming — truncate with an error
                    await self._stream_error_frame(
                        out, f"upstream settled non-stream (HTTP {terminal.status})"
                    )
                    return http.STREAMED
                # the leg died with the cursor intact: fail over and
                # re-splice at last_acked_offset + 1
                tried.add(choice.engine_id)
                nxt = None
                if attempts < max_attempts:
                    if multi:
                        nxt = self.router.pick(agent, session=session_hint, exclude=frozenset(tried))
                        if nxt is None:
                            # every survivor already tried: re-open the full
                            # set (a respawned replica may be back)
                            nxt = self.router.pick(agent, session=session_hint)
                    else:
                        await asyncio.sleep(0.5)
                        endpoint = self.s.manager.endpoint(agent)
                        nxt = None if endpoint is None else ReplicaChoice(agent.engine_id, endpoint)
                if nxt is None:
                    break
                choice = nxt
                if out.started or cursor > floor:
                    self.stream_failovers_total += 1
                if request_id:
                    self._journal_op(self.s.journal.set_replica, agent_id, request_id, choice.engine_id)
        except asyncio.CancelledError:
            self.stream_client_disconnects_total += 1
            await self._abort_stream(agent_id, request_id, choice)
            raise
        except _StreamClientGone:
            self.stream_client_disconnects_total += 1
            await self._abort_stream(agent_id, request_id, choice)
            return http.STREAMED if out.started else Response(499, {"error": "client disconnected"})
        except StreamGapError as e:
            # a hard invariant break, never skipped: the entry stays
            # unsettled (PROCESSING) and the replay reclaim re-serves it
            # buffered, where the archived response is whole or nothing
            try:
                self.s.logs.error("proxy", f"stream gap on {agent_id}: {e}")
            except Exception:
                pass
            if not out.started:
                raise
            await self._stream_error_frame(out, str(e))
            return http.STREAMED
        finally:
            gone.cancel()

        # every leg exhausted: back to pending (the replay settles it
        # buffered); the client may reconnect with Last-Event-ID and the
        # request id to re-splice what it is owed
        if request_id:
            self._journal_op(self.s.journal.mark_pending, agent_id, request_id)
        if out.started:
            await self._stream_error_frame(
                out, "upstream lost mid-stream; reconnect with Last-Event-ID to resume"
            )
            return http.STREAMED
        return fail("agent unreachable; request left pending for replay", status=502, headers=rid_headers)

    async def _stream_error_frame(self, out, message: str) -> None:
        """Best-effort terminal error frame on a started stream (a stream
        with no ``done`` IS the failure signal; the frame names the reason)."""
        try:
            payload = json.dumps({"error": message}, separators=(",", ":"))
            await out.write(f"event: {STREAM_EVENT_ERROR}\ndata: {payload}\n\n".encode())
        except Exception:
            # the consumer is already gone
            self.stream_write_errors_total += 1

    async def _abort_stream(self, agent_id: str, request_id: str, choice) -> None:
        """Streamed client hang-up: settle the entry EXPIRED at the last
        acked offset and cancel the lane on the replica serving the stream."""
        if request_id:
            self._journal_op(
                self.s.journal.mark_expired, agent_id, request_id,
                reason="client disconnected mid-stream",
            )
        if choice is not None and request_id:
            await self._cancel_on_engine(choice.endpoint, request_id)

    # -- tiered-KV proxy policy (park on settle, prewarm on arrival) ------
    def _tier_enabled(self) -> bool:
        return bool(self.s.config.features.kv_tiering)

    def _tier_on_arrival(self, agent_id: str, session: str) -> None:
        """The next turn arrived: cancel a pending park and, for a parked
        session, send the prewarm hint fire-and-forget."""
        key = (agent_id, session)
        task = self._tier_linger_tasks.pop(key, None)
        if task is not None:
            task.cancel()
        if key in self._tier_parked:
            self._tier_parked.discard(key)
            t = asyncio.ensure_future(self._tier_prewarm(agent_id, session))
            self._tier_bg.add(t)
            t.add_done_callback(self._tier_bg.discard)

    def _tier_schedule_park(self, agent_id: str, session: str) -> None:
        """Response complete: park the session after the linger window
        unless it speaks again first."""
        key = (agent_id, session)
        old = self._tier_linger_tasks.pop(key, None)
        if old is not None:
            old.cancel()
        linger = float(self.s.config.features.tier_park_linger_s or 0.0)
        task = asyncio.ensure_future(self._tier_park_later(agent_id, session, linger))
        self._tier_linger_tasks[key] = task

        def _done(t, key=key):
            if self._tier_linger_tasks.get(key) is t:
                self._tier_linger_tasks.pop(key, None)

        task.add_done_callback(_done)

    async def _tier_park_later(self, agent_id: str, session: str, linger: float) -> None:
        try:
            if linger > 0:
                await asyncio.sleep(linger)
            status, _headers, rbody = await self.dispatch_to_agent(
                agent_id, "POST", "/park", {"Content-Type": "application/json"},
                json.dumps({"session": session}).encode(),
            )
            parked = False
            if status == 200:
                try:
                    parked = bool(json.loads(rbody).get("parked"))
                except (ValueError, AttributeError, UnicodeDecodeError):
                    parked = False
            if parked:
                self._tier_parked.add((agent_id, session))
                self.tier_parks_total += 1
            else:
                self.tier_park_failures_total += 1
        except asyncio.CancelledError:
            raise  # the session spoke again; parking would be wrong now
        except Exception:
            self.tier_park_failures_total += 1

    async def _tier_prewarm(self, agent_id: str, session: str) -> None:
        try:
            await self.dispatch_to_agent(
                agent_id, "POST", "/prewarm", {"Content-Type": "application/json"},
                json.dumps({"session": session}).encode(),
            )
            self.tier_prewarms_total += 1
        except Exception:
            self.tier_park_failures_total += 1

    async def _await_archived(
        self, agent_id: str, request_id: str, deadline_at: float | None
    ) -> Response | None:
        """Wait for another dispatcher's settlement of a journal entry and
        serve its outcome; None if it never settles in budget."""
        budget = 30.0 if deadline_at is None else max(0.5, deadline_at - time.time())
        end = time.monotonic() + min(30.0, budget)
        while time.monotonic() < end:
            try:
                req = self.s.journal.get(agent_id, request_id)
            except Exception:
                self._store_breaker.fail()
                self.journal_errors_total += 1
                return fail(
                    "store unavailable; request state unknown, will replay",
                    status=503,
                    headers={
                        "Retry-After": str(
                            retry_after_jitter(self._store_breaker.cooldown_s, self._retry_rng)
                        )
                    },
                )
            if req is None:
                return None
            if req.status == RequestStatus.COMPLETED and req.response:
                r = req.response
                body = base64.b64decode(r["body_b64"]) if r.get("body_b64") else b""
                return _relay(r.get("status_code", 200), r.get("headers", {}), body, request_id)
            if req.status == RequestStatus.EXPIRED:
                return fail("deadline exceeded; request dead-lettered", status=504)
            if req.status == RequestStatus.FAILED:
                return fail("agent request failed; retry recorded", status=504)
            await asyncio.sleep(0.05)
        return None

    async def _cancel_on_engine(self, endpoint: str, request_id: str) -> None:
        """Best-effort engine-side abort for a request whose waiter is gone."""
        if not endpoint.startswith("http"):
            return
        try:
            await http.request(
                "POST",
                endpoint.rstrip("/") + "/cancel",
                {"Content-Type": "application/json"},
                json.dumps({"request_id": request_id}).encode(),
                timeout=2.0,
            )
        except Exception:
            # advisory (a dead engine makes it moot), but counted
            self.abort_cancel_errors_total += 1
