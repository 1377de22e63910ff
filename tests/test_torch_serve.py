"""The port's standard-library serve layer on the CPU with ``tiny``.

Routes and JSON keys as the reference's ``engine/llm_serve.py`` handlers
(``h_health``, ``h_chat``, ``h_history``, ``h_clear``, ``h_metrics``,
``h_generate``); one server for the whole module.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from agentainer_tpu_torch.engine.llm_serve import LLMServeApp

# keys of the reference handlers' JSON bodies (agentainer_tpu/engine/llm_serve.py)
HEALTH_KEYS = {"status", "agent_id", "model_loaded", "uptime_s"}
CHAT_KEYS = {"response", "agent", "model", "usage", "ttft_ms", "ttft_breakdown"}
ROOT_KEYS = {"agent", "engine", "model", "chips", "status"}


@pytest.fixture(scope="module")
def server():
    app = LLMServeApp(env={
        "AGENTAINER_AGENT_ID": "agent-t",
        "AGENTAINER_MODEL_CONFIG": "tiny",
        "AGENTAINER_MODEL_OPTIONS": json.dumps({"device": "cpu", "max_batch": 2, "max_seq": 128}),
    })
    th = threading.Thread(target=lambda: asyncio.run(app.run("127.0.0.1", 0)), daemon=True)
    th.start()
    deadline = time.monotonic() + 120
    while (app.port is None or app.engine is None) and not app.engine_error:
        assert time.monotonic() < deadline, "server did not come up"
        time.sleep(0.05)
    assert not app.engine_error
    yield app
    app.stop()
    th.join(timeout=30)
    assert not th.is_alive()


def call(app, method, path, body=None, raw=None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{app.port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health_and_root(server):
    status, doc = call(server, "GET", "/health")
    assert status == 200 and set(doc) == HEALTH_KEYS
    assert doc["status"] == "healthy" and doc["model_loaded"] is True
    status, doc = call(server, "GET", "/")
    assert status == 200 and set(doc) == ROOT_KEYS and doc["status"] == "running"


def test_chat_twice_history_metrics_clear(server):
    s1, a = call(server, "POST", "/chat", {"message": "hi there", "session": "s1", "max_tokens": 5})
    s2, b = call(server, "POST", "/chat", {"message": "again", "session": "s1", "max_tokens": 5})
    assert s1 == s2 == 200
    for doc in (a, b):
        assert set(doc) == CHAT_KEYS
        assert set(doc["usage"]) == {"prompt_tokens", "completion_tokens"}
        assert doc["model"] == "tiny" and doc["agent"] == "agent-t"
        assert doc["usage"]["completion_tokens"] > 0
    eng = server.engine
    assert "agent-t::s1" in eng.sessions  # the session keeps its slot

    status, hist = call(server, "GET", "/history")
    assert status == 200 and hist["count"] == 4
    assert [t["role"] for t in hist["history"]] == ["user", "assistant"] * 2
    assert [t["content"] for t in hist["history"][::2]] == ["hi there", "again"]

    status, m = call(server, "GET", "/metrics")
    assert status == 200 and m["engine"] == "llm" and m["model_loaded"] is True
    assert m["tokens_generated"] >= 2 and m["requests_total"] >= 3
    assert set(m["kernel_launches"]) == {
        "flash_prefill", "flash_decode", "fused_paged_flash_prefill", "fused_paged_flash_decode",
        "w8a16_matmul", "w8a16_grouped_matmul",
    }
    assert m["paged_kv"] is False

    status, doc = call(server, "POST", "/clear")
    assert status == 200 and doc == {"status": "cleared"}
    assert call(server, "GET", "/history")[1]["count"] == 0
    assert "agent-t::s1" not in eng.sessions


def test_generate(server):
    status, doc = call(server, "POST", "/generate", {"prompt": "abc", "max_tokens": 4})
    assert status == 200
    assert {"text", "tokens", "prompt_tokens", "completion_tokens", "ttft_ms"} <= set(doc)
    assert doc["prompt_tokens"] == 4  # bos + 3 bytes


def test_errors(server):
    assert call(server, "GET", "/nope")[0] == 404
    assert call(server, "GET", "/chat")[0] == 405
    status, doc = call(server, "POST", "/chat", raw=b"{not json")
    assert status == 400 and doc == {"error": "invalid JSON"}


class _StubEngine:
    """Duck-typed engine for the reference serve app: only the JSON shape of
    its handlers is under test here."""

    sessions: dict = {}
    streaming = False

    async def chat(self, session, message, max_tokens=64, request_id="", **kw):
        return {"text": "x", "tokens": [3], "prompt_tokens": 2, "completion_tokens": 1,
                "ttft_ms": 1.0, "ttft_breakdown": None}

    def metrics(self):
        return {}

    def drain(self, budget_s):
        return True

    def clear_sessions(self, prefix=""):
        pass

    def shutdown(self):
        pass


def test_json_keys_match_the_reference_app(server):
    """The reference aiohttp app (with a stub engine) and the port answer
    /chat and /health with the same keys."""
    from aiohttp.test_utils import TestClient, TestServer

    from agentainer_tpu.engine.llm_serve import LLMServeApp as ReferenceApp

    async def reference_docs():
        ref = ReferenceApp(env={"AGENTAINER_AGENT_ID": "ref"})
        ref.engine = _StubEngine()
        async with TestClient(TestServer(ref.app())) as client:
            chat = await (await client.post("/chat", json={"message": "hi"})).json()
            health = await (await client.get("/health")).json()
        return chat, health

    ref_chat, ref_health = asyncio.run(reference_docs())
    _, chat = call(server, "POST", "/chat", {"message": "hi", "max_tokens": 2})
    _, health = call(server, "GET", "/health")
    assert set(chat) == set(ref_chat) == CHAT_KEYS
    assert set(chat["usage"]) == set(ref_chat["usage"])
    assert set(health) == set(ref_health) == HEALTH_KEYS
