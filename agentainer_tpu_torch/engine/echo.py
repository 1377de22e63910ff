"""Mock-LLM echo engine — HTTP-contract parity with the reference example
agents (examples/gpt-agent/app.py), minus the external LLM API.

Reference: ``agentainer_tpu/engine/echo.py``. The same routes (``GET /``
info, ``GET /health``, ``POST /chat``, ``GET /history``, ``POST /clear``,
``GET /metrics``) and the same JSON. Conversation turns persist through the
control plane's store at ``agent:{AGENT_ID}:conversations``, trimmed to 50
exchanges, so history survives an engine crash. The reference serves from a
hand-rolled ``asyncio.Protocol`` with keep-alive; this one serves through
the port's one HTTP reader and writer (``utils/http``), one request per
connection, and logs one access line per request to stdout (the engine log
that ``/agents/{id}/logs`` tails). Standard library only: it never imports
torch.
"""

from __future__ import annotations

import asyncio
import json
import os
import time

from ..runtime.store_client import StoreClient
from ..utils import http

MAX_TURNS = 50  # app.py:58 trim parity


class EchoEngine:
    def __init__(self) -> None:
        self.agent_id = os.environ.get("AGENTAINER_AGENT_ID", "standalone")
        self.agent_name = os.environ.get("AGENTAINER_AGENT_NAME", self.agent_id)
        self.store = StoreClient.from_env()
        self.started_at = time.time()
        self.requests_total = 0
        self.chats_total = 0

    @property
    def convo_key(self) -> str:
        return f"agent:{self.agent_id}:conversations"

    @property
    def metrics_key(self) -> str:
        return f"agent:{self.agent_id}:metrics"

    async def handle(self, req: http.Request) -> http.Response:
        route = {
            ("GET", "/"): self.h_root,
            ("GET", "/health"): self.h_health,
            ("POST", "/chat"): self.h_chat,
            ("GET", "/history"): self.h_history,
            ("POST", "/clear"): self.h_clear,
            ("GET", "/metrics"): self.h_metrics,
        }.get((req.method, req.path))
        try:
            resp = await route(req) if route else http.Response(404, {"error": "not found"})
        except Exception as e:  # a failed handler answers, and logs
            resp = http.Response(500, {"error": f"{type(e).__name__}: {e}"})
        print(f"{time.strftime('%H:%M:%S')} access {req.method} {req.path} {resp.status}", flush=True)
        return resp

    # -- handlers -----------------------------------------------------------
    async def h_root(self, req: http.Request) -> http.Response:
        return http.Response(
            200,
            {
                "agent": self.agent_name,
                "engine": "echo",
                "status": "running",
                "endpoints": ["/health", "/chat", "/history", "/clear", "/metrics"],
            },
        )

    async def h_health(self, req: http.Request) -> http.Response:
        self.requests_total += 1
        return http.Response(
            200,
            {"status": "healthy", "agent_id": self.agent_id, "uptime_s": time.time() - self.started_at},
        )

    async def h_chat(self, req: http.Request) -> http.Response:
        self.requests_total += 1
        self.chats_total += 1
        try:
            message = str(req.json().get("message", ""))
        except (ValueError, AttributeError):
            return http.Response(400, {"error": "invalid JSON"})
        reply = f"Echo: {message}"
        now = time.time()
        try:
            # one pipelined round-trip; rpush returns the post-push length so
            # conversation_length needs no extra llen (ltrim caps it)
            results = await self.store.pipeline(
                [
                    {
                        "op": "rpush",
                        "key": self.convo_key,
                        "values": [
                            json.dumps({"role": "user", "content": message, "ts": now}),
                            json.dumps({"role": "assistant", "content": reply, "ts": now}),
                        ],
                    },
                    {"op": "ltrim", "key": self.convo_key, "start": -2 * MAX_TURNS, "stop": -1},
                    {"op": "hincrby", "key": self.metrics_key, "field": "chats", "amount": 1},
                ]
            )
            n = min(int(results[0]), 2 * MAX_TURNS)
        except Exception:
            n = -1  # store unreachable: still serve (availability over convo durability)
        return http.Response(
            200, {"response": reply, "agent": self.agent_name, "conversation_length": n}
        )

    async def h_history(self, req: http.Request) -> http.Response:
        self.requests_total += 1
        try:
            raw = await self.store.lrange(self.convo_key, 0, -1)
        except Exception:
            raw = []
        turns = []
        for item in raw:
            try:
                turns.append(json.loads(item))
            except json.JSONDecodeError:
                continue
        return http.Response(200, {"history": turns, "count": len(turns)})

    async def h_clear(self, req: http.Request) -> http.Response:
        self.requests_total += 1
        try:
            await self.store.delete(self.convo_key)
        except Exception:
            pass
        return http.Response(200, {"status": "cleared"})

    async def h_metrics(self, req: http.Request) -> http.Response:
        return http.Response(
            200,
            {
                "engine": "echo",
                "requests_total": self.requests_total,
                "chats_total": self.chats_total,
                "uptime_s": time.time() - self.started_at,
            },
        )


def serve() -> None:
    engine = EchoEngine()
    port = int(os.environ.get("AGENTAINER_PORT", "8000"))

    async def main() -> None:
        server = await http.start_server(engine.handle, "127.0.0.1", port)
        async with server:
            await server.serve_forever()

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass
