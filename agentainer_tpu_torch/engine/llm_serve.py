"""LLM engine process — serves the PyTorch engine over the engine HTTP
contract: ``/`` ``/health`` ``/chat`` ``/generate`` ``/history`` ``/clear``
``/cancel`` ``/profile`` ``/metrics`` ``/park`` ``/prewarm``.

Reference: ``agentainer_tpu/engine/llm_serve.py``. Same routes, same request
and response JSON, same ``AGENTAINER_*`` environment contract: the model
config, ``AGENTAINER_CHECKPOINT`` (a HuggingFace directory), the persona,
the assigned chips (``AGENTAINER_CHIPS``, passed as ``options["chips"]``)
and the fleet defaults in the ``ATPU_*`` variables (``_engine_options``).
What differs:

- the HTTP server is the standard library's (``asyncio.start_server`` and a
  minimal HTTP/1.1 reader, one request per connection): the machine with the
  card has no aiohttp;
- conversation turns live in the process-local store that the reference's
  ``StoreClient`` falls back to with no control plane configured. The
  reference snapshots a session's KV to the store after its turns, restores
  an unknown session from the store before admitting it and snapshots the
  resident sessions in the drain, all only with a connected store; so they
  wait for the store client, which calls the engine's
  ``snapshot_session``/``restore_session`` (ported). ``/park`` and
  ``/prewarm`` (with ``kv_tiering``) demote a session into the engine's
  host tier and promote it back; with no store connected the park's blob
  is written nowhere and a prewarm has no cold tier to fall back to, as in
  the reference without a store. Tenants come with a later slice;
- SSE streaming (``stream=true`` on ``/chat`` with the engine's
  ``streaming`` option; a body asking for it with the option off is
  answered buffered, as in the reference): the standard-library server
  writes the reference's frames (``_sse_frame``) one at a time, draining
  each, with no Content-Length and ``Connection: close``; the status line
  goes out with the first frame, so a failure before it still answers
  with its plain status (the poisoned-prefill 500 included). A client that
  hangs up is seen as end of file on the connection (``SSEStream``) and
  cancels its engine request;
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

Engine options ride ``AGENTAINER_MODEL_OPTIONS`` (JSON), including
``device`` (default ``"cuda"``). Run: ``python -m
agentainer_tpu_torch.engine.llm_serve`` with ``AGENTAINER_PORT`` and
``AGENTAINER_MODEL_CONFIG`` set.
"""

from __future__ import annotations

import asyncio
import contextlib
import fnmatch
import json
import os
import signal
import threading
import time
import traceback
from dataclasses import dataclass
from urllib.parse import urlsplit

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
_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    413: "Payload Too Large", 429: "Too Many Requests", 499: "Client Closed Request",
    500: "Internal Server Error", 503: "Service Unavailable", 504: "Gateway Timeout",
}
_MAX_BODY = 16 << 20
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


class LocalStore:
    """Process-local key/value + list store: the semantics of the reference
    ``StoreClient``'s fallback when no control plane is configured
    (``runtime/store_client.py``). State dies with the process."""

    def __init__(self) -> None:
        self._d: dict[str, list[str]] = {}

    async def rpush(self, key: str, *values: str) -> int:
        self._d.setdefault(key, []).extend(values)
        return len(self._d[key])

    async def lrange(self, key: str, start: int = 0, stop: int = -1) -> list[str]:
        return self._d.get(key, [])[start : (stop + 1 if stop != -1 else None)]

    async def ltrim(self, key: str, start: int, stop: int) -> None:
        self._d[key] = self._d.get(key, [])[start : (stop + 1 if stop != -1 else None)]

    async def expire(self, key: str, ttl: float) -> bool:
        return key in self._d  # no sweeper: state dies with the process

    async def delete(self, key: str) -> int:
        return 1 if self._d.pop(key, None) is not None else 0

    async def keys(self, pattern: str) -> list[str]:
        return [k for k in self._d if fnmatch.fnmatchcase(k, pattern)]


class SSEStream:
    """One connection's streamed response. The status line and headers go
    out with the first frame, so a handler that fails before it still
    answers with a plain ``Response``; every frame is drained before the
    next. ``hangup()`` completes when the client closes its side (end of
    file on the connection, or a read error)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self.started = False

    async def write(self, data: bytes) -> None:
        if not self.started:
            self.started = True
            head = [
                "HTTP/1.1 200 OK",
                f"Content-Type: {STREAM_CONTENT_TYPE}",
                "Cache-Control: no-cache",
                "X-Accel-Buffering: no",
                "Connection: close",
            ]
            self._writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        self._writer.write(data)
        await self._writer.drain()

    def hangup(self) -> asyncio.Task:
        async def until_eof() -> None:
            with contextlib.suppress(ConnectionError):
                while await self._reader.read(4096):
                    pass

        return asyncio.ensure_future(until_eof())


@dataclass
class Request:
    method: str
    path: str
    headers: dict[str, str]  # lower-cased names
    body: bytes
    # the connection, for a handler that streams its response
    stream: SSEStream | None = None

    def json(self):
        """The body as JSON; raises ValueError when malformed."""
        return json.loads(self.body or b"null")


@dataclass
class Response:
    status: int
    doc: dict | None
    headers: dict[str, str] | None = None
    # the handler wrote the response itself (an SSE stream)
    streamed: bool = False


class LLMServeApp:
    """One agent's serving surface (one per process, env-configured)."""

    def __init__(self, env: dict | None = None) -> None:
        E = os.environ if env is None else env
        self._env = E
        self.engine = None
        self.engine_error = ""
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
        self.store = LocalStore()
        # drain on the way out: budget, outcome
        try:
            self.drain_budget_s = float(
                self.model_options.get("drain_budget_s", E.get("AGENTAINER_DRAIN_BUDGET_S", 10.0))
            )
        except (TypeError, ValueError):
            self.drain_budget_s = 10.0
        self.draining = False
        self.drained_clean: bool | None = None
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

    def _sess(self, session: str) -> str:
        """Engine-side session namespace (matches the reference's)."""
        return f"{self.agent_id}::{session}"

    @property
    def convo_key(self) -> str:
        return f"agent:{self.agent_id}:conversations"

    def _convo_session_key(self, session: str) -> str:
        return f"{self.convo_key}:{session}"

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

    # -- lifecycle ----------------------------------------------------------
    def _load_engine(self) -> None:
        """Build the engine (weights + warmup: slow). Runs on a daemon
        thread so /health answers while loading."""
        try:
            from .llm import LLMEngine

            engine = LLMEngine.create(
                config_name=self.config_name,
                checkpoint=self.checkpoint,
                options=self._engine_options(),
            )
            asyncio.run(self._prewarm_prefix(engine))
            self.engine = engine
        except Exception as e:  # engine stays None; /chat reports 503
            self.engine_error = f"{type(e).__name__}: {e}"
            traceback.print_exc()
        finally:
            self._ready.set()

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

    async def run(self, host: str = "127.0.0.1", port: int = 8000) -> None:
        """Serve until ``stop()``; loads the engine in the background unless
        one was injected before. On the way out the engine drains (no new
        admissions, 503 + draining; in-flight work finishes within
        ``drain_budget_s``), then the server closes and the engine shuts
        down."""
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        if self.engine is None:
            threading.Thread(target=self._load_engine, daemon=True, name="model-loader").start()
        else:
            self._ready.set()
        server = await asyncio.start_server(self._handle_conn, host, port)
        self.port = server.sockets[0].getsockname()[1]
        try:
            await self._stop.wait()
            if self.engine is not None:
                self.draining = True
                self.drained_clean = await asyncio.to_thread(self.engine.drain, self.drain_budget_s)
        finally:
            server.close()
            await server.wait_closed()
            if self.engine is not None:
                await asyncio.to_thread(self.engine.shutdown)

    def stop(self) -> None:
        """Thread-safe: ask ``run`` to drain the engine and return."""
        if self._loop is not None and self._stop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)

    # -- HTTP ---------------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            if isinstance(req, Request):
                req.stream = SSEStream(reader, writer)
            resp = req if isinstance(req, Response) else await self._dispatch(req)
            if resp.streamed:
                return
            body = json.dumps(resp.doc).encode()
            head = [
                f"HTTP/1.1 {resp.status} {_REASONS.get(resp.status, 'Unknown')}",
                "Content-Type: application/json; charset=utf-8",
                f"Content-Length: {len(body)}",
                "Connection: close",
            ]
            head += [f"{k}: {v}" for k, v in (resp.headers or {}).items()]
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass  # client went away, or sent a line past the reader's limit
        finally:
            writer.close()

    async def _read_request(self, reader: asyncio.StreamReader) -> Request | Response | None:
        """One request off the connection; None for an empty or garbled
        request line, a 413 Response for a bad Content-Length."""
        line = await reader.readline()
        if not line.strip():
            return None
        parts = line.decode("latin-1").split()
        if len(parts) != 3:
            return None
        method, target, _ = parts
        headers: dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        try:
            n = int(headers.get("content-length", "0") or 0)
        except ValueError:
            n = -1
        if n < 0 or n > _MAX_BODY:
            return Response(413, {"error": "bad or oversized Content-Length"})
        body = await reader.readexactly(n) if n else b""
        return Request(method, urlsplit(target).path or "/", headers, body)

    async def _dispatch(self, req: Request) -> Response:
        handler = self._routes.get((req.method, req.path))
        if handler is None:
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
            await asyncio.to_thread(self._ready.wait, 2.0)
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
        return Response(
            200,
            {
                "status": "draining" if self.draining else "healthy",
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
        """The last ``window`` turns of one session, from its own list. (The
        reference also reads turns recorded on the shared conversation key
        before the per-session lists; this process-local store never holds
        any.)"""
        turns = []
        for item in await self.store.lrange(self._convo_session_key(session), -window, -1):
            try:
                turns.append(json.loads(item))
            except json.JSONDecodeError:
                continue
        return turns

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
        await self.store.rpush(
            key,
            json.dumps({"role": "user", "content": message, "ts": now, "session": session}),
            json.dumps({"role": "assistant", "content": reply, "ts": now, "session": session}),
        )
        await self.store.ltrim(key, -2 * MAX_TURNS, -1)
        await self.store.expire(key, SESSION_CONVO_TTL_S)

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
        keys = [self.convo_key] + sorted(await self.store.keys(f"{self.convo_key}:*"))
        for key in keys:
            for item in await self.store.lrange(key, 0, -1):
                try:
                    turns.append(json.loads(item))
                except json.JSONDecodeError:
                    continue
        turns.sort(key=lambda t: t.get("ts", 0.0))
        return Response(200, {"history": turns, "count": len(turns)})

    async def h_clear(self, req: Request) -> Response:
        self.requests_total += 1
        await self.store.delete(self.convo_key)
        for key in await self.store.keys(f"{self.convo_key}:*"):
            await self.store.delete(key)
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
        trace_dir = self._env.get("AGENTAINER_PROFILE_DIR", "") or os.path.join(
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
        engine's host tier. The answer carries the exact blob's size; with
        no store connected the blob is written nowhere."""
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
        return Response(200, {"parked": True, "bytes": len(blob)})

    async def h_prewarm(self, req: Request) -> Response:
        """Tiering hint: promote a parked session onto the device ahead of
        its next turn (best effort: a turn promotes it anyway)."""
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
            "prefix_prewarms": self.prefix_prewarms,
            "kv_parks": self.kv_parks,
            "kv_park_errors": self.kv_park_errors,
            "kv_prewarms": self.kv_prewarms,
            "kv_prewarm_errors": self.kv_prewarm_errors,
            "drain_budget_s": self.drain_budget_s,
            "drained_clean": self.drained_clean,
            "flatten_history": self.flatten_history,
            "streams_started": self.streams_started,
            "stream_tokens_emitted": self.stream_tokens_emitted,
            "stream_heartbeats": self.stream_heartbeats,
            "stream_client_disconnects": self.stream_client_disconnects,
        }
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
