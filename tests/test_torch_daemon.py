"""The port's control plane against the reference's, on the CPU.

- **API transcript**: one scripted sequence of management and proxy calls
  (deploy → start → chat → stop → pause → resume of an echo agent with a
  real engine process, the verify skill's probes — 401, malformed deploy
  400, unknown engine 400, unknown agent 404, stop of a created agent 409,
  /internal/store outside the namespace 403 — a crash and its replay, the
  journal, the history and the audit log) goes to the reference's daemon
  (aiohttp, ``mem://``, no native data plane) and to the port's
  (``utils/http``). Status codes and JSON must be equal up to ids,
  timestamps, ports and pids; the archived responses' headers are left out
  (each server adds its own: aiohttp's ``Date``/``Server``, the port's
  ``Connection: close``).
- **Store**: seeded random sequences of store ops (strings, TTLs, sets,
  lists, sorted sets, hashes, ``cas``, pattern pub/sub) through both
  ``MemoryStore``s give equal results.
- The slices' refusals: the artifacts and backups routes (501); a
  ``replicas: 2`` deploy is served by two engines; ``native://`` opens the
  C++ store and ``native:///x.aof`` reopens its data; an engine's store
  client round-trips over the native store's unix socket.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import os
import random
import re
import time

import pytest
from aiohttp.test_utils import TestServer

from agentainer_tpu.config import Config as JConfig
from agentainer_tpu.daemon import build_services as jbuild_services
from agentainer_tpu.runtime.local import LocalBackend as JLocalBackend
from agentainer_tpu.store import MemoryStore as JMemoryStore
from agentainer_tpu.store.schema import Keys
from agentainer_tpu_torch.config import Config
from agentainer_tpu_torch.daemon import build_services, start_background, start_daemon, stop_daemon
from agentainer_tpu_torch.runtime.local import LocalBackend
from agentainer_tpu_torch.runtime.store_client import StoreClient
from agentainer_tpu_torch.store import MemoryStore, open_store
from agentainer_tpu_torch.utils import http

TOKEN = "torch-daemon-token"
AUTH = {"Authorization": f"Bearer {TOKEN}"}
SLICE = {"total_chips": 8, "hbm_per_chip": 16 * 1024**3, "name": "test-slice-8"}


class Stack:
    """One running daemon: its services and a client for its URL."""

    def __init__(self, services, url: str):
        self.services = services
        self.url = url

    async def call(self, method: str, path: str, body=None, headers=None, raw: bytes | None = None):
        """(status, JSON document or text) of one request."""
        data = raw if raw is not None else (b"" if body is None else json.dumps(body).encode())
        status, _, out = await http.request(
            method, self.url + path, {"Content-Type": "application/json", **(headers or {})}, data,
            timeout=120,
        )
        try:
            return status, json.loads(out)
        except ValueError:
            return status, out.decode("utf-8", "replace")

    def engine_token(self, agent_id: str) -> str:
        return self.services.store.get(Keys.internal_token(agent_id)).decode()


def _configure(cfg):
    cfg.auth_token = TOKEN
    for k, v in SLICE.items():
        setattr(cfg.slice, k, v)
    return cfg


@contextlib.asynccontextmanager
async def port_stack(tmp_path, background: bool = False, ready_timeout_s: float = 60.0,
                     streaming: bool = False):
    """The port's daemon on a free port with a real process backend; like
    the reference's test stack, with no background loops unless asked (the
    test drives the reconciler and the replay worker itself)."""
    backend = LocalBackend(data_dir=str(tmp_path / "port"), ready_timeout_s=ready_timeout_s)
    config = _configure(Config())
    config.features.streaming = streaming
    services = build_services(
        config=config, store=MemoryStore(), backend=backend,
        console_logs=False, data_dir=str(tmp_path / "port"),
    )
    server = await start_daemon(services, "127.0.0.1", 0)
    if background:
        await start_background(services)
    try:
        yield Stack(services, f"http://127.0.0.1:{services.public_port}")
    finally:
        await stop_daemon(services, server)


@contextlib.asynccontextmanager
async def reference_stack(tmp_path):
    """The reference's daemon (aiohttp, mem://, no native data plane)."""
    backend = JLocalBackend(data_dir=str(tmp_path / "ref"), ready_timeout_s=60.0)
    services = jbuild_services(
        config=_configure(JConfig()), store=JMemoryStore(), backend=backend,
        console_logs=False, data_dir=str(tmp_path / "ref"),
    )
    server = TestServer(services.app, host="127.0.0.1")
    await server.start_server()
    backend.set_control(f"http://127.0.0.1:{server.port}", TOKEN)
    try:
        yield Stack(services, f"http://127.0.0.1:{server.port}")
    finally:
        backend.close()
        await server.close()


# -- the API transcript ---------------------------------------------------------

_VOLATILE = {
    "id", "agent_id", "engine_id", "request_id", "replica_id", "created_at",
    "updated_at", "time", "ts", "uptime_s", "ip", "user_agent",
}
_PATTERNS = (
    (re.compile(r"agent-\d+"), "agent-ID"),
    (re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}"), "REQUEST-ID"),
    (re.compile(r"eng-[0-9a-f]{12}"), "eng-ID"),
)


def _norm(x, key: str = ""):
    """A document with ids, times, ports and pids masked, and the journal's
    base64 bodies decoded."""
    if key in _VOLATILE:
        return "<volatile>"
    if key == "deadline_at":
        return None if x is None else "<deadline>"
    if key in ("body_b64",) and isinstance(x, str):
        raw = base64.b64decode(x)
        try:
            return _norm(json.loads(raw))
        except ValueError:
            return raw.decode("utf-8", "replace")
    if key == "response" and isinstance(x, dict) and "status_code" in x:
        return {"status_code": x["status_code"], "body": _norm(x.get("body_b64", ""), "body_b64")}
    if isinstance(x, dict):
        return {k: _norm(v, k) for k, v in x.items()}
    if isinstance(x, list):
        return [_norm(v) for v in x]
    if isinstance(x, str):
        for rx, sub in _PATTERNS:
            x = rx.sub(sub, x)
    return x


async def _transcript(st: Stack) -> list:
    s = st.services
    out = []

    async def step(label, method, path, body=None, headers=None, raw=None):
        status, doc = await st.call(method, path, body, headers, raw)
        out.append((label, status, _norm(doc)))
        return status, doc

    await step("list no auth", "GET", "/agents")
    await step("list bad auth", "GET", "/agents", headers={"Authorization": "Bearer wrong"})
    await step("deploy malformed", "POST", "/agents", headers=AUTH, raw=b"{not json")
    await step("deploy unknown engine", "POST", "/agents", {"name": "x", "model": "nope"}, AUTH)
    await step("deploy unnamed", "POST", "/agents", {"model": "echo"}, AUTH)
    _, doc = await step("deploy", "POST", "/agents", {"name": "echo-t", "model": "echo"}, AUTH)
    aid = doc["data"]["id"]
    await step("proxy unknown agent", "POST", "/agent/agent-0/chat", {"message": "hi"})
    await step("stop created", "POST", f"/agents/{aid}/stop", headers=AUTH)
    await step("start", "POST", f"/agents/{aid}/start", headers=AUTH)
    await step("chat", "POST", f"/agent/{aid}/chat", {"message": "hi"})
    await step("history", "GET", f"/agent/{aid}/history")
    eng = {"Authorization": f"Bearer {st.engine_token(aid)}", "X-Agentainer-Agent-ID": aid}
    await step("store outside namespace", "POST", "/internal/store",
               {"op": "get", "key": "agent:someone-else:conversations"}, eng)
    await step("store pattern outside", "POST", "/internal/store",
               {"op": "keys", "key": f"agent:{aid}:x", "pattern": "agent:*"}, eng)
    await step("store no credentials", "POST", "/internal/store",
               {"op": "llen", "key": f"agent:{aid}:conversations"})
    await step("store llen", "POST", "/internal/store",
               {"op": "llen", "key": f"agent:{aid}:conversations"}, eng)
    await step("stop", "POST", f"/agents/{aid}/stop", headers=AUTH)
    await step("pause stopped", "POST", f"/agents/{aid}/pause", headers=AUTH)
    await step("resume stopped", "POST", f"/agents/{aid}/resume", headers=AUTH)
    await step("pause", "POST", f"/agents/{aid}/pause", headers=AUTH)
    await step("chat paused", "POST", f"/agent/{aid}/chat", {"message": "while paused"})
    await step("resume", "POST", f"/agents/{aid}/resume", headers=AUTH)
    # the crash: SIGKILL, the reconciler sees it, the next request queues
    s.backend.kill_engine_hard(s.manager.get_agent(aid).engine_id)
    s.quick_sync.sync_agent(aid)
    await step("chat crashed", "POST", f"/agent/{aid}/chat", {"message": "during crash"})
    await step("pending", "GET", f"/agents/{aid}/requests", headers=AUTH)
    await step("resume crashed", "POST", f"/agents/{aid}/resume", headers=AUTH)
    out.append(("replayed", await s.replay.scan_once(), None))
    await step("completed", "GET", f"/agents/{aid}/requests?status=completed", headers=AUTH)
    await step("pending after", "GET", f"/agents/{aid}/requests", headers=AUTH)
    await step("history after", "GET", f"/agent/{aid}/history")
    await step("get", "GET", f"/agents/{aid}", headers=AUTH)
    await step("unknown route", "GET", "/nope", headers=AUTH)
    await step("remove", "DELETE", f"/agents/{aid}", headers=AUTH)
    await step("get removed", "GET", f"/agents/{aid}", headers=AUTH)
    await step("audit", "GET", "/audit", headers=AUTH)
    return out


def test_api_transcript_matches_reference(tmp_path):
    async def body():
        async with reference_stack(tmp_path) as ref:
            want = await _transcript(ref)
        async with port_stack(tmp_path) as port:
            got = await _transcript(port)
        return want, got

    want, got = asyncio.run(body())
    assert [w[0] for w in want] == [g[0] for g in got]
    for w, g in zip(want, got):
        assert g == w, f"step {w[0]!r}"
    statuses = {label: status for label, status, _ in got}
    assert statuses["list no auth"] == 401 and statuses["deploy malformed"] == 400
    assert statuses["store outside namespace"] == 403 and statuses["chat crashed"] == 202
    assert statuses["replayed"] == 2


# -- the store ----------------------------------------------------------------


def _store_ops(store, seed: int) -> list:
    """A seeded random op sequence; returns every op's result (pub/sub
    messages collected through a pattern subscription)."""
    rng = random.Random(seed)
    keys = [f"k{i}" for i in range(4)]
    sub = store.psubscribe("chan:*")
    out = []
    for _ in range(300):
        k = rng.choice(keys)
        op = rng.choice([
            "set", "set_ttl", "get", "delete", "exists", "keys", "expire", "ttl_none",
            "sadd", "srem", "smembers", "rpush", "lpush", "lrem", "lrange", "llen", "ltrim",
            "zadd", "zrange", "zrem", "zcard", "hset", "hincrby", "hgetall", "cas", "publish",
        ])
        v = f"v{rng.randrange(5)}"
        try:
            if op == "set":
                r = store.set(k, v)
            elif op == "set_ttl":
                r = store.set(k, v, ttl=3600)
            elif op == "get":
                r = store.get(k)
            elif op == "delete":
                r = store.delete(k, rng.choice(keys))
            elif op == "exists":
                r = store.exists(k)
            elif op == "keys":
                r = sorted(store.keys(rng.choice(["*", "k[12]", "k?", "x*"])))
            elif op == "expire":
                r = store.expire(k, 3600)
            elif op == "ttl_none":
                t = store.ttl(k)
                r = None if t is None else round(t, -2)
            elif op == "sadd":
                r = store.sadd(k, v, f"v{rng.randrange(5)}")
            elif op == "srem":
                r = store.srem(k, v)
            elif op == "smembers":
                r = sorted(store.smembers(k))
            elif op == "rpush":
                r = store.rpush(k, v, v + "x")
            elif op == "lpush":
                r = store.lpush(k, v)
            elif op == "lrem":
                r = store.lrem(k, rng.choice([0, 1, -1]), v)
            elif op == "lrange":
                r = store.lrange(k, rng.randrange(-3, 2), rng.choice([-1, 0, 2, 5]))
            elif op == "llen":
                r = store.llen(k)
            elif op == "ltrim":
                r = store.ltrim(k, rng.randrange(-3, 2), rng.choice([-1, 1, 3]))
            elif op == "zadd":
                r = store.zadd(k, float(rng.randrange(10)), v)
            elif op == "zrange":
                r = store.zrangebyscore(k, rng.randrange(5), rng.randrange(5, 12))
            elif op == "zrem":
                r = store.zremrangebyscore(k, 0, rng.randrange(6))
            elif op == "zcard":
                r = store.zcard(k)
            elif op == "hset":
                r = store.hset(k, rng.choice("ab"), v)
            elif op == "hincrby":
                r = store.hincrby(k, rng.choice("ab"), rng.randrange(-2, 3))
            elif op == "hgetall":
                r = sorted(store.hgetall(k).items())
            elif op == "cas":
                r = store.cas(k, rng.choice([None, "v0", "v1"]), v)
            else:
                r = store.publish(rng.choice(["chan:a", "chan:b", "other"]), v)
        except Exception as e:  # a wrong-type op: the same error both ways
            r = f"{type(e).__name__}"
        out.append((op, r))
    # TTLs: a short one expires, a long one survives
    store.set("short", "x", ttl=0.05)
    store.set("long", "y", ttl=60)
    time.sleep(0.1)
    out.append(("expired", store.get("short"), store.get("long"), sorted(store.keys("*o*"))))
    out.append(("messages", sub.drain()))
    sub.close()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_memory_store_op_sequences_match_reference(seed):
    assert _store_ops(MemoryStore(), seed) == _store_ops(JMemoryStore(), seed)


# -- what waits for later slices ------------------------------------------------


def test_later_slices_are_refused_by_name(tmp_path):
    assert isinstance(open_store("mem://"), MemoryStore)

    async def body():
        async with port_stack(tmp_path) as st:
            res = {}
            for method, path in (("POST", "/backups"), ("GET", "/backups"), ("GET", "/artifacts"),
                                 ("POST", "/backups/b1/restore"), ("DELETE", "/artifacts/a")):
                res[(method, path)] = await st.call(method, path, {}, AUTH)
            res["artifact"] = await st.call(
                "POST", "/agents", {"name": "a", "model": {"artifact": "m"}}, AUTH
            )
            return res

    res = asyncio.run(body())
    for key in [k for k in res if isinstance(k, tuple)] + ["artifact"]:
        status, doc = res[key]
        assert status == 501 and doc["success"] is False and "slice of the port" in doc["message"], key


def test_native_store_opens_and_its_aof_reopens(tmp_path):
    """``native://`` is the C++ store (no AOF); ``native:///x.aof`` keeps its
    data across a close and a reopen, TTLs included."""
    from agentainer_tpu_torch.store.native import NativeStore

    s = open_store("native://")
    assert isinstance(s, NativeStore)
    s.set("k", "v")
    assert s.get("k") == b"v"
    s.close()
    aof = tmp_path / "x.aof"
    s = open_store(f"native://{aof}")
    s.set("agent:a", json.dumps({"id": "a"}))
    s.rpush("agent:a:requests:pending", "r1", "r2")
    s.set("ttl", "x", ttl=600)
    s.close()
    s = open_store(f"native://{aof}")
    try:
        assert json.loads(s.get("agent:a")) == {"id": "a"}
        assert s.lrange("agent:a:requests:pending", 0, -1) == [b"r1", b"r2"]
        assert 590 < s.ttl("ttl") <= 600
    finally:
        s.close()


@pytest.mark.parametrize("long_path", [False, True])
def test_store_client_round_trips_over_the_store_socket(tmp_path, long_path):
    """An engine's ``StoreClient`` given ``AGENTAINER_STORE_SOCK`` and no
    control URL: ops, raw snapshot bytes and a pipeline go over the C++
    data plane's unix socket into the native store, inside the agent's
    namespace; a wrong token is refused. A socket path past ``sun_path``'s
    108 bytes works the same (through its directory's descriptor)."""
    from agentainer_tpu_torch.runtime.dataplane import UDS_PATH_MAX, NativeDataPlane

    if long_path:
        tmp_path = tmp_path / ("d" * 100)
        tmp_path.mkdir()
    store = open_store(f"native://{tmp_path}/store.aof")
    sock = str(tmp_path / "store.sock")
    assert (len(sock) > UDS_PATH_MAX) == long_path
    dp = NativeDataPlane(store, "127.0.0.1", 0, "127.0.0.1", 1, sock)
    store.set(Keys.internal_token("a1"), "tok")
    blob = bytes(range(256)) * 4096  # a 1 MiB binary snapshot

    async def body():
        client = StoreClient(store_sock=sock, agent_id="a1", token="tok")
        assert client.connected
        try:
            await client.set("agent:a1:k", "v", ttl=60)
            await client.set_bytes("agent:a1:kvcache:s", blob)
            res = await client.pipeline([
                {"op": "rpush", "key": "agent:a1:conversations", "values": ["x", "y"]},
                {"op": "get", "key": "agent:a1:k"},
                {"op": "llen", "key": "agent:a1:conversations"},
            ])
            got = await client.get_bytes("agent:a1:kvcache:s")
        finally:
            await client.close()
        bad = StoreClient(store_sock=sock, agent_id="a1", token="wrong", retries=0)
        with pytest.raises(RuntimeError, match="credentials"):
            await bad.get("agent:a1:k")
        return res, got

    try:
        res, got = asyncio.run(body())
        assert res == [2, "v", 2] and got == blob
        assert store.get("agent:a1:kvcache:s") == blob
        assert store.lrange("agent:a1:conversations", 0, -1) == [b"x", b"y"]
        assert os.path.exists(sock)
    finally:
        dp.stop()
        store.close()
    assert not os.path.exists(sock)  # unlinked at stop


def test_replicas_deploy_starts_one_engine_per_replica(tmp_path):
    """The fleet is ported: a ``replicas: 2`` deploy answers 200 and its
    start makes two engine processes, each with its own port."""

    async def body():
        async with port_stack(tmp_path) as st:
            status, doc = await st.call(
                "POST", "/agents", {"name": "f", "model": "echo", "replicas": 2}, AUTH
            )
            assert status == 200, doc
            aid = doc["data"]["id"]
            status, doc = await st.call("POST", f"/agents/{aid}/start", headers=AUTH)
            assert status == 200, doc
            rec = st.services.manager.get_agent(aid)
            backend = st.services.backend
            procs = {backend._recs[e].proc.pid for e in rec.replica_ids}
            endpoints = {backend.engine_info(e).endpoint for e in rec.replica_ids}
            status, reply = await st.call("POST", f"/agent/{aid}/chat", {"message": "hi"})
            return rec, procs, endpoints, status, reply

    rec, procs, endpoints, status, reply = asyncio.run(body())
    assert len(rec.replica_ids) == 2 and rec.engine_id == rec.replica_ids[0]
    assert len(procs) == 2 and len(endpoints) == 2
    assert status == 200 and reply["response"] == "Echo: hi"


def test_slice_defaults_come_from_the_card(monkeypatch):
    """No nvidia-smi here: 0 GPUs unless ATPU_SLICE_CHIPS says otherwise;
    an H100's memory per card."""
    from agentainer_tpu_torch import config as tconfig

    assert tconfig.detect_gpus()[0] == 0
    cfg = tconfig.load_config(path="/nonexistent/config.yaml")
    assert cfg.slice.total_chips == 0 and cfg.slice.hbm_per_chip == tconfig.DEFAULT_GPU_MEMORY
    monkeypatch.setenv("ATPU_SLICE_CHIPS", "4")
    cfg = tconfig.load_config(path="/nonexistent/config.yaml")
    assert cfg.slice.total_chips == 4 and cfg.slice.name == "gpu-4"
