"""The port's daemon behind the C++ front door, end to end on the CPU.

The port's daemon over ``native://<dir>/store.aof`` with
``features.native_dataplane``: the C++ listener (``native/dataplane.cc``,
built by the port's loader) on the public port, the port's
standard-library server behind it on a loopback port, engines reaching the
store over the unix socket. The reference's ``tests/test_dataplane.py``
scenarios on the port — a proxy round trip journaled by the C++ (the
journal id in the answer, the record completed, the C++ counters in
``/agents/{id}/metrics``), crash → 202 queue → resume → replay, HEAD, a
chunked request body and ``Connection: close`` (and the malformed chunk
sizes the C++ refuses), the socket pipeline's namespace checked atomically,
records and journal surviving a daemon restart — plus:

- a ``replicas: 2`` agent: the hook leaves its route to Python, so its
  ``/agent/*`` is forwarded and dispatched by the routing tier
  (``picks_total`` moves);
- the same script of calls against the reference's daemon with its own C++
  front door (its library built once, under a file lock, by the fixture
  here): equal statuses, documents and journal states, up to ids and
  times;
- streams: a streamed ``llm:tiny`` ``/chat`` (f32, CPU) through the front
  door arrives whole — it reads the engine's chunked stream to its last
  chunk and answers it buffered, as the reference's does — with the token
  ids of the buffered ``/chat``; and ``utils/http`` reads a chunked stream
  frame by frame.
"""

from __future__ import annotations

import asyncio
import contextlib
import fcntl
import json
import os
import time

import pytest

from agentainer_tpu_torch import native
from agentainer_tpu_torch.config import Config
from agentainer_tpu_torch.core.protocol import REQUEST_ID_HEADER
from agentainer_tpu_torch.daemon import build_services, start_background, start_daemon, stop_daemon
from agentainer_tpu_torch.runtime.local import LocalBackend
from agentainer_tpu_torch.runtime.store_client import StoreClient
from agentainer_tpu_torch.store.schema import Keys
from agentainer_tpu_torch.utils import http

from .test_torch_daemon import AUTH, Stack, _configure, _norm
from .test_torch_fleet_e2e import _events


@pytest.fixture(scope="module", autouse=True)
def built():
    """The port's library: a failed build fails these tests."""
    assert native.available(), native.load_error()


@contextlib.asynccontextmanager
async def native_stack(tmp_path, background: bool = False, streaming: bool = False):
    """The port's daemon with the native store and the C++ front door on a
    free port (no background loops unless asked)."""
    ddir = str(tmp_path / "port")
    backend = LocalBackend(data_dir=os.path.join(ddir, "runtime"), ready_timeout_s=60.0)
    cfg = _configure(Config())
    cfg.store_url = f"native://{ddir}/store.aof"
    cfg.features.streaming = streaming
    services = build_services(config=cfg, backend=backend, console_logs=False, data_dir=ddir)
    server = await start_daemon(services, "127.0.0.1", 0)
    assert services.dataplane is not None, "the C++ front door did not start"
    if background:
        await start_background(services)
    try:
        yield Stack(services, f"http://127.0.0.1:{services.public_port}")
    finally:
        await stop_daemon(services, server)
        services.store.close()


async def _echo(st: Stack, name: str, **extra) -> str:
    status, doc = await st.call("POST", "/agents", {"name": name, "model": "echo", **extra}, AUTH)
    assert status == 200, doc
    aid = doc["data"]["id"]
    status, doc = await st.call("POST", f"/agents/{aid}/start", headers=AUTH)
    assert status == 200, doc
    return aid


async def _settled(journal, aid: str, completed: int, timeout: float = 10.0) -> dict:
    """The journal's stats once ``completed`` entries settled (the C++
    settles on a background thread) and none is pending."""
    deadline = time.monotonic() + timeout
    while True:
        stats = journal.stats(aid)
        if (stats["completed"] >= completed and stats["pending"] == 0) or time.monotonic() > deadline:
            return stats
        await asyncio.sleep(0.05)


async def _raw(port: int, payload: bytes, timeout: float = 8.0) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(payload)
    await writer.drain()
    data = await asyncio.wait_for(reader.read(1 << 20), timeout)
    writer.close()
    return data


def test_native_proxy_round_trip(tmp_path):
    async def body():
        async with native_stack(tmp_path) as st:
            s = st.services
            assert s.store_url.startswith("native://") and s.store_url.endswith("/store.aof")
            status, doc = await st.call("GET", "/health")  # forwarded C++ → Python
            assert status == 200 and doc["data"]["status"] == "healthy"
            aid = await _echo(st, "dp-echo")
            status, headers, raw = await http.request(
                "POST", f"{st.url}/agent/{aid}/chat", {}, json.dumps({"message": "native hello"}).encode()
            )
            assert status == 200, raw
            span = headers.get(REQUEST_ID_HEADER, "")
            doc = json.loads(raw)
            assert span and doc["response"] == "Echo: native hello" and doc["conversation_length"] == 2
            assert (await _settled(s.journal, aid, 1))["completed"] == 1
            status, doc = await st.call("GET", f"/agents/{aid}/requests?status=completed", headers=AUTH)
            rec = doc["data"]["requests"][0]
            assert (rec["id"], rec["method"], rec["path"]) == (span, "POST", "/chat")
            assert rec["response"]["status_code"] == 200 and rec["replica_id"] == ""
            assert rec["stream_offset"] == -1  # the C++ record's missing fields read as defaults
            # the C++ counters reach the agent's metrics
            s.metrics.sample_agent(aid)
            status, doc = await st.call("GET", f"/agents/{aid}/metrics", headers=AUTH)
            assert status == 200 and doc["data"]["proxy"]["requests"] == 1
            status, doc = await st.call("POST", "/agent/agent-nope/chat", {})
            assert status == 404 and doc["success"] is False

    asyncio.run(body())


def test_native_crash_queue_resume_replay(tmp_path):
    async def body():
        async with native_stack(tmp_path) as st:
            s = st.services
            aid = await _echo(st, "dp-crash")
            assert (await st.call("POST", f"/agent/{aid}/chat", {"message": "before"}))[0] == 200
            s.backend.kill_engine_hard(s.manager.get_agent(aid).engine_id)
            # before the reconciler sees it: refused → 502, left pending
            status, _ = await st.call("POST", f"/agent/{aid}/chat", {"message": "during"})
            assert status == 502 and s.journal.stats(aid)["pending"] == 1
            s.quick_sync.sync_agent(aid)  # stopped → the route says so → 202
            status, doc = await st.call("POST", f"/agent/{aid}/chat", {"message": "still down"})
            assert status == 202 and doc["data"]["status"] == "pending"
            assert (await st.call("POST", f"/agents/{aid}/resume", headers=AUTH))[0] == 200
            assert await s.replay.scan_once() == 2
            stats = await _settled(s.journal, aid, 3)
            assert stats == {"pending": 0, "completed": 3, "failed": 0, "expired": 0}
            _, hist = await st.call("GET", f"/agent/{aid}/history")
            assert {"before", "during", "still down"} <= {t["content"] for t in hist["history"]}

    asyncio.run(body())


def test_head_chunked_and_connection_close(tmp_path):
    async def body():
        async with native_stack(tmp_path) as st:
            aid = await _echo(st, "dp-edge")
            port = st.services.public_port
            t0 = time.monotonic()
            raw = await _raw(port, b"HEAD /health HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
            assert raw.startswith(b"HTTP/1.1 200") and time.monotonic() - t0 < 5.0
            chat = json.dumps({"message": "chunked hello"}).encode()
            raw = await _raw(
                port,
                b"POST /agent/" + aid.encode() + b"/chat HTTP/1.1\r\nHost: x\r\n"
                b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n"
                + b"%x\r\n" % len(chat) + chat + b"\r\n0\r\n\r\n",
            )
            assert raw.startswith(b"HTTP/1.1 200") and b"Echo: chunked hello" in raw
            raw = await _raw(
                port, b"GET /agent/" + aid.encode() + b"/health HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
            )
            assert raw.startswith(b"HTTP/1.1 200") and b"Connection: close" in raw
            for bad in (b"zz\r\nGET /agent/x HTTP/1.1\r\n\r\n", b"7fffffffffff\r\n"):
                raw = await _raw(
                    port,
                    b"POST /agent/" + aid.encode() + b"/chat HTTP/1.1\r\nHost: x\r\n"
                    b"Transfer-Encoding: chunked\r\n\r\n" + bad,
                )
                assert not raw.startswith(b"HTTP/1.1 200"), raw[:80]

    asyncio.run(body())


def test_store_socket_pipeline_namespace_is_atomic(tmp_path):
    async def body():
        async with native_stack(tmp_path) as st:
            s = st.services
            aid = await _echo(st, "dp-ns")
            token = s.store.get(Keys.internal_token(aid)).decode()
            assert s.backend.store_sock == os.path.join(s.data_dir, "store.sock")
            client = StoreClient(store_sock=s.backend.store_sock, agent_id=aid, token=token)
            try:
                with pytest.raises(RuntimeError, match="namespace"):
                    await client.pipeline([
                        {"op": "set", "key": f"agent:{aid}:mine", "value": "1"},
                        {"op": "set", "key": "agent:other:theirs", "value": "2"},
                        {"op": "rpush", "key": f"agent:{aid}:lst", "values": ["x"]},
                    ])
                assert s.store.get(f"agent:{aid}:mine") is None
                assert s.store.get("agent:other:theirs") is None
                assert s.store.lrange(f"agent:{aid}:lst", 0, -1) == []
                assert await client.pipeline([{"op": "set", "key": f"agent:{aid}:ok", "value": "9"}]) == [None]
                assert s.store.get(f"agent:{aid}:ok") == b"9"
            finally:
                await client.close()
            # the echo engine's own conversation writes went over the socket
            status, _ = await st.call("POST", f"/agent/{aid}/chat", {"message": "uds"})
            assert status == 200 and s.store.llen(Keys.conversations(aid)) == 2

    asyncio.run(body())


class _SnapshotEngine:
    """An engine whose session snapshot is a given blob; it keeps what a
    restore hands it."""

    def __init__(self, blob: bytes):
        self.blob = blob
        self.restored: bytes | None = None

    async def snapshot_session(self, session: str) -> bytes:
        return self.blob

    async def restore_session(self, session: str, blob: bytes) -> bool:
        self.restored = blob
        return True


@pytest.mark.parametrize("mib,path", [(60, "socket"), (70, "http")])
def test_a_snapshot_past_the_socket_frame_cap_lands(tmp_path, mib, path):
    """An engine's serve layer configured as the daemon configures it on
    ``native://`` (store socket and control URL) snapshots a session of
    ``mib`` MiB and restores it: a frame that fits the C++'s 64 MiB cap goes
    over the socket, a larger blob over HTTP through the front door, and
    no frame past the cap is ever written to the socket. Both land with no
    error, retry or transient error, and read back over the socket equal.
    A client with no control URL refuses the large frame without a retry."""
    import numpy as np

    from agentainer_tpu_torch.engine.llm_serve import LLMServeApp
    from agentainer_tpu_torch.runtime.store_client import SOCKET_FRAME_MAX, FrameTooLarge

    blob = np.random.default_rng(mib).integers(0, 256, mib << 20, dtype=np.uint8).tobytes()

    async def body():
        async with native_stack(tmp_path) as st:
            s = st.services
            s.store.set(Keys.internal_token("snap"), "tok")
            app = LLMServeApp(env={
                "AGENTAINER_AGENT_ID": "snap", "AGENTAINER_INTERNAL_TOKEN": "tok",
                "AGENTAINER_CONTROL_URL": st.url,
                "AGENTAINER_STORE_SOCK": os.path.join(s.data_dir, "store.sock"),
            })
            app.engine = _SnapshotEngine(blob)
            frames = []
            roundtrip = app.store._uds.roundtrip

            async def spy(frame):
                frames.append(len(frame))
                return await roundtrip(frame)

            app.store._uds.roundtrip = spy
            try:
                await app._snapshot_now("s")
                restored = await app._restore_from_store("s")
            finally:
                await app.store.close()
            stored = s.store.get("agent:snap:kvcache:s")
            bare = StoreClient(store_sock=app.store.store_sock, agent_id="snap", token="tok")
            try:
                with pytest.raises(FrameTooLarge):
                    await bare.set_bytes("agent:snap:kvcache:t", blob + bytes(6 << 20))
            finally:
                await bare.close()
            return app, restored, stored, frames, bare

    app, restored, stored, frames, bare = asyncio.run(body())
    assert app.kv_snapshot_errors == 0 and app.kv_snapshots == 1, app.last_kv_snapshot_error
    assert app.last_kv_snapshot["path"] == path and app.last_kv_snapshot["bytes"] == len(blob)
    assert restored and app.kv_restores == 1 and app.engine.restored == blob and stored == blob
    assert (app.store.retries_total, app.store.transient_errors_total) == (0, 0)
    assert max(frames) <= SOCKET_FRAME_MAX
    assert (max(frames) > len(blob)) == (path == "socket")  # the set went over the socket
    assert (bare.retries_total, bare.transient_errors_total) == (0, 0)


def test_records_and_journal_survive_a_daemon_restart(tmp_path):
    async def body():
        async with native_stack(tmp_path) as st:
            aid = await _echo(st, "survivor")
            assert (await st.call("POST", f"/agent/{aid}/chat", {"message": "hi"}))[0] == 200
            await _settled(st.services.journal, aid, 1)
        async with native_stack(tmp_path) as st2:
            status, doc = await st2.call("GET", "/agents", headers=AUTH)
            assert [a["id"] for a in doc["data"]] == [aid]
            status, doc = await st2.call("GET", f"/agents/{aid}/requests?status=completed", headers=AUTH)
            assert doc["data"]["stats"]["completed"] == 1
            # the conversation the engine wrote over the socket, from the AOF
            return [json.loads(t)["content"] for t in st2.services.store.lrange(Keys.conversations(aid), 0, -1)]

    assert asyncio.run(body()) == ["hi", "Echo: hi"]


def test_a_fleet_is_dispatched_by_the_routing_tier(tmp_path):
    async def body():
        async with native_stack(tmp_path) as st:
            s = st.services
            aid = await _echo(st, "dp-fleet", replicas=2)
            before = s.router.picks_total
            for i in range(4):
                status, doc = await st.call("POST", f"/agent/{aid}/chat", {"message": f"m{i}", "session": f"s{i}"})
                assert status == 200 and doc["response"] == f"Echo: m{i}"
            stats = await _settled(s.journal, aid, 4)
            replicas = {e.replica_id for e in s.journal.by_status(aid, "completed")}
            return s.router.picks_total - before, stats, replicas, s.manager.get_agent(aid).replica_ids

    picks, stats, replicas, ids = asyncio.run(body())
    assert picks >= 4 and stats["completed"] == 4
    assert replicas <= set(ids) and "" not in replicas  # journaled by Python, per replica


# -- the reference's daemon with its C++ front door, on the same script --------------


@pytest.fixture(scope="module")
def reference_native():
    """The reference's library (``make -C native``), built once under a file
    lock so two workers never run that make at once from here."""
    from agentainer_tpu import native as jnative

    os.makedirs(native.BUILD_DIR, exist_ok=True)
    with open(os.path.join(native.BUILD_DIR, "reference-native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not jnative.available():
            jnative._load_error = None  # a concurrent make elsewhere: once more
            assert jnative.available(), jnative.load_error()


@contextlib.asynccontextmanager
async def reference_native_stack(tmp_path):
    from agentainer_tpu.config import Config as JConfig
    from agentainer_tpu.daemon import build_services as jbuild_services
    from agentainer_tpu.daemon import run_daemon
    from agentainer_tpu.runtime.local import LocalBackend as JLocalBackend

    ddir = str(tmp_path / "ref")
    cfg = _configure(JConfig())
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    cfg.store_url = f"native://{ddir}/store.aof"
    services = jbuild_services(
        config=cfg, backend=JLocalBackend(data_dir=ddir, ready_timeout_s=60.0),
        console_logs=False, data_dir=ddir,
    )
    task = asyncio.create_task(run_daemon(services))
    for _ in range(200):
        if services.dataplane is not None:
            break
        await asyncio.sleep(0.05)
    assert services.dataplane is not None
    try:
        yield Stack(services, f"http://127.0.0.1:{services.dataplane.port}")
    finally:
        task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await task
        services.store.close()


async def _script(st: Stack) -> list:
    s = st.services
    out = []

    async def step(label, method, path, body=None, headers=None, raw=None):
        status, doc = await st.call(method, path, body, headers, raw)
        out.append((label, status, _norm(doc)))
        return status, doc

    await step("health", "GET", "/health")
    _, doc = await step("deploy", "POST", "/agents", {"name": "echo-n", "model": "echo"}, AUTH)
    aid = doc["data"]["id"]
    await step("proxy unknown agent", "POST", "/agent/agent-0/chat", {"message": "hi"})
    await step("chat before start", "POST", f"/agent/{aid}/chat", {"message": "early"})
    await step("start", "POST", f"/agents/{aid}/start", headers=AUTH)
    out.append(("early replayed", await _settled(s.journal, aid, 1)))  # on the engine's ready kick
    await step("chat", "POST", f"/agent/{aid}/chat", {"message": "hi"})
    await step("chat again", "POST", f"/agent/{aid}/chat", {"message": "again"})
    await step("history", "GET", f"/agent/{aid}/history")
    await step("engine root", "GET", f"/agent/{aid}/")
    s.backend.kill_engine_hard(s.manager.get_agent(aid).engine_id)
    s.quick_sync.sync_agent(aid)
    await step("chat crashed", "POST", f"/agent/{aid}/chat", {"message": "during crash"})
    await step("resume", "POST", f"/agents/{aid}/resume", headers=AUTH)
    out.append(("stats", await _settled(s.journal, aid, 5)))
    for status_name in ("completed", "pending", "failed"):
        _, doc = await st.call("GET", f"/agents/{aid}/requests?status={status_name}", headers=AUTH)
        reqs = sorted(doc["data"]["requests"], key=lambda r: (r["created_at"], r["path"]))
        out.append((status_name, [
            {k: _norm(r[k], k) for k in ("method", "path", "status", "retry_count", "error", "response")}
            for r in reqs
        ]))
    await step("history after", "GET", f"/agent/{aid}/history")
    return out


def test_script_matches_the_reference_native_daemon(tmp_path, reference_native):
    async def body():
        async with reference_native_stack(tmp_path) as ref:
            want = await _script(ref)
        async with native_stack(tmp_path, background=True) as st:
            got = await _script(st)
        return got, want

    got, want = asyncio.run(body())
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert g == w, g[0]


# -- streams --------------------------------------------------------------------------


def test_a_streamed_chat_through_the_front_door_arrives_whole(tmp_path):
    """llm:tiny (f32, CPU, seeded random weights): the C++ reads the
    engine's chunked SSE stream to its last chunk and answers it buffered
    (never an empty 200): ids 0..n-1 and one ``done``, whose payload —
    text and usage — equals a buffered /chat's of the same prompt in
    another session (a buffered answer carries no token ids); the C++
    journal completed both."""
    opts = {"device": "cpu", "max_batch": 2, "max_seq": 256, "streaming": True}

    async def body():
        async with native_stack(tmp_path, streaming=True) as st:
            s = st.services
            model = {"engine": "llm", "config": "tiny", "options": opts}
            status, doc = await st.call("POST", "/agents", {"name": "tiny", "model": model}, AUTH)
            assert status == 200, doc
            aid = doc["data"]["id"]
            assert (await st.call("POST", f"/agents/{aid}/start", headers=AUTH))[0] == 200
            deadline = time.monotonic() + 120
            while not (s.backend.stats(s.manager.get_agent(aid).engine_id) or {}).get("model_loaded"):
                assert time.monotonic() < deadline
                await asyncio.sleep(0.2)
            turn = {"message": "hello there", "max_tokens": 12, "ignore_eos": True}
            status, headers, raw = await http.request(
                "POST", f"{st.url}/agent/{aid}/chat", {}, json.dumps({**turn, "session": "C", "stream": True}).encode()
            )
            status_b, _, raw_b = await http.request(
                "POST", f"{st.url}/agent/{aid}/chat", {}, json.dumps({**turn, "session": "D"}).encode()
            )
            stats = await _settled(s.journal, aid, 2)
            return status, headers, raw, status_b, json.loads(raw_b), stats

    status, headers, raw, status_b, buffered, stats = asyncio.run(body())
    assert status == 200 and headers["Content-Type"].startswith("text/event-stream")
    assert int(headers["Content-Length"]) == len(raw) > 0  # buffered by the C++
    events = _events(raw)
    tokens = [e for e in events if e[0] == "token"]
    assert [e[1] for e in tokens] == list(range(12))
    done = [e for e in events if e[0] != "token"]
    assert [e[0] for e in done] == ["done"] and done[0][1] == 11
    assert status_b == 200
    for key in ("response", "usage", "agent", "model"):
        assert done[0][2][key] == buffered[key], key
    assert buffered["usage"]["completion_tokens"] == 12
    assert stats["completed"] == 2


def test_http_reads_a_chunked_stream_frame_by_frame():
    """A handler's three frames, written apart, arrive as three chunks
    (``BodyReader.read``) and then the end; an HTTP/1.0 request gets the
    same body unframed, read to the close; ``read_body`` decodes both."""
    frames = [b"event: token\nid: %d\ndata: {}\n\n" % i for i in range(3)]

    async def handler(req: http.Request) -> http.Response:
        req.stream.headers = {"Content-Type": "text/event-stream"}
        for f in frames:
            await req.stream.write(f)
            await asyncio.sleep(0.05)
        return http.STREAMED

    async def body():
        server = await http.start_server(handler, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/"
        try:
            status, headers, reader, writer = await http.open_stream("GET", url)
            pieces, stamps = [], []
            try:
                upstream = http.BodyReader(reader, headers)
                while piece := await upstream.read():
                    pieces.append(piece)
                    stamps.append(time.monotonic())
            finally:
                writer.close()
            _, _, whole = await http.request("GET", url)
            reader, writer = await asyncio.open_connection("127.0.0.1", server.sockets[0].getsockname()[1])
            writer.write(b"GET / HTTP/1.0\r\n\r\n")
            raw10 = await reader.read()
            writer.close()
            return status, headers, pieces, stamps, whole, raw10
        finally:
            server.close()

    status, headers, pieces, stamps, whole, raw10 = asyncio.run(body())
    assert status == 200 and headers["Transfer-Encoding"] == "chunked"
    assert pieces == frames and stamps[2] - stamps[0] > 0.05
    assert whole == b"".join(frames)
    head, _, rest = raw10.partition(b"\r\n\r\n")
    assert b"chunked" not in head.lower() and rest == b"".join(frames)
