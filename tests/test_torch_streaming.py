"""SSE token streaming in the port against the JAX package on the CPU.

The engine side: ``GenRequest.emit`` reports tokens from the readbacks the
worker processes anyway (first token, decode chunks, verify rounds), in
order and contiguous from offset 0 (the reference's
tests/test_streaming.py::test_engine_emit_offsets_contiguous_per_chunk),
with speculation on and off.

The serve side: the port's standard-library server and the reference's
aiohttp app, each over its own engine with the same ``tiny`` weights (f32,
the JAX ``init_params`` tree) and the streaming option, answer the same
requests — a streamed first turn, a streamed second turn, and the first
request again under its request id with ``Last-Event-ID: 4`` (a memoized
replay re-emitted from the cursor) — with the same ``token`` events (event,
id, offset, token, text delta) and the same ``done`` payload, timing fields
aside. A streamed request's ``done`` carries the buffered body of the same
prompt, its ids run 0..n-1, and it makes as many host syncs as the buffered
one.

The serve layer's own behaviour, over a duck-typed engine: heartbeats are
comment frames that never advance an offset, a client that hangs up
cancels its engine request, the option off answers buffered, and a
poisoned prefill answers its 500 before any frame.
"""

import asyncio
import contextlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.engine.tokenizer import ByteTokenizer as JTok
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models.llama import init_params as jinit
from agentainer_tpu_torch.core.protocol import PREFILL_POISON_HEADER
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.llm import PrefillFailed, RequestCancelled
from agentainer_tpu_torch.engine.llm_serve import LLMServeApp
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy

SHAPE = dict(max_batch=4, max_seq=256, decode_chunk=8, prefill_chunk=32)
ENV = {
    "AGENTAINER_AGENT_ID": "sse-t",
    "AGENTAINER_MODEL_CONFIG": "tiny",
    "ATPU_STREAM_HEARTBEAT_S": "60",
}
JSON_LOOP = '{"tool": "search", "args": {"q": "w", "n": 5}}\n' * 4
TIMING = ("ttft_ms", "ttft_breakdown")
# (name, headers, body) of the scenario both apps serve, in order
SCENARIO = (
    ("first_turn", {"X-Agentainer-Request-ID": "r1"},
     {"message": "hello there", "session": "s1", "max_tokens": 12, "stream": True}),
    ("second_turn", {},
     {"message": " and then?", "session": "s1", "max_tokens": 10, "stream": True}),
    ("replay_after_cursor", {"X-Agentainer-Request-ID": "r1", "Last-Event-ID": "4"},
     {"message": "hello there", "session": "s1", "max_tokens": 12, "stream": True}),
)


def parse_sse(raw: bytes) -> list[dict]:
    """SSE frames: {"event", "id", "data"} or {"comment"}."""
    frames = []
    for block in raw.decode().split("\n\n"):
        if not block.strip():
            continue
        frame: dict = {}
        for line in block.split("\n"):
            if line.startswith(":"):
                frame["comment"] = line[1:].strip()
            else:
                key, _, value = line.partition(": ")
                frame[key] = json.loads(value) if key == "data" else value
        frames.append(frame)
    return frames


def _untimed(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k not in TIMING}


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp))


def port_engine(weights, **kw):
    _, _, tcfg, tp = weights
    eng = TEngine(tcfg, tp, TTok(tcfg.vocab_size), **SHAPE, **kw, device="cpu")
    eng.warmup()
    return eng


@contextlib.contextmanager
def serving(engine, **env):
    """The port's app over ``engine`` on a local port (shut down after)."""
    app = LLMServeApp(env={**ENV, **env})
    app.engine = engine
    th = threading.Thread(target=lambda: asyncio.run(app.run("127.0.0.1", 0)), daemon=True)
    th.start()
    deadline = time.monotonic() + 30
    while app.port is None:
        assert time.monotonic() < deadline, "server did not come up"
        time.sleep(0.01)
    try:
        yield app
    finally:
        app.stop()
        th.join(timeout=30)


def post(app, path, body, headers=None):
    """(status, headers, raw body) of one request to the port's app."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{app.port}{path}", data=json.dumps(body).encode(), method="POST",
        headers=headers or {},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def get_json(app, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{app.port}{path}", timeout=60) as resp:
        return json.loads(resp.read())


# -- engine: emit offsets ------------------------------------------------


@pytest.mark.parametrize("speculative", [True, False], ids=["spec_on", "spec_off"])
def test_emit_offsets_are_contiguous_and_equal_the_tokens(weights, speculative):
    eng = port_engine(weights, speculative=speculative)
    try:
        emitted = []
        res = asyncio.run(eng.generate(
            JSON_LOOP, max_tokens=24, ignore_eos=True,
            emit=lambda start, ids: emitted.append((start, list(ids))),
        ))
        rounds = eng.metrics()["spec_rounds"]
    finally:
        eng.shutdown()
    seq = []
    for start, ids in emitted:
        assert start == len(seq)  # contiguous from offset 0, in order
        seq.extend(ids)
    assert seq == res["tokens"] and len(seq) == 24
    assert (rounds > 0) == speculative


# -- serve: the same events as the reference -----------------------------


@pytest.fixture(scope="module")
def reference_frames(weights):
    from aiohttp.test_utils import TestClient, TestServer

    from agentainer_tpu.engine.llm_serve import LLMServeApp as JApp

    jcfg, jp, _, _ = weights

    async def drive():
        ref = JApp(env=dict(ENV))
        ref.stream_heartbeat_s = 60.0
        ref.engine = JEngine(jcfg, jp, JTok(jcfg.vocab_size), **SHAPE, streaming=True)
        out = {}
        async with TestClient(TestServer(ref.app())) as client:
            for name, headers, body in SCENARIO:
                resp = await client.post("/chat", json=body, headers=headers)
                assert resp.status == 200
                out[name] = parse_sse(await resp.read())
        return out

    return asyncio.run(drive())


@pytest.fixture(scope="module")
def port_run(weights):
    out = {}
    with serving(port_engine(weights, streaming=True)) as app:
        for name, headers, body in SCENARIO:
            status, hdrs, raw = post(app, "/chat", body, headers)
            assert status == 200 and hdrs["Content-Type"] == "text/event-stream"
            out[name] = parse_sse(raw)
        # one prompt buffered, then streamed, in fresh sessions
        m0 = get_json(app, "/metrics")
        body = {"message": "a buffered prompt", "max_tokens": 16, "ignore_eos": True}
        status, _, raw = post(app, "/chat", {**body, "session": "h1"})
        m1 = get_json(app, "/metrics")
        _, _, streamed = post(app, "/chat", {**body, "session": "h2", "stream": True})
        m2 = get_json(app, "/metrics")
        out["buffered"] = json.loads(raw)
        out["streamed"] = parse_sse(streamed)
        out["syncs"] = (
            m1["host_syncs_total"] - m0["host_syncs_total"],
            m2["host_syncs_total"] - m1["host_syncs_total"],
        )
        out["metrics"] = m2
    return out


@pytest.mark.parametrize("name", [s[0] for s in SCENARIO])
def test_token_events_equal_the_reference(reference_frames, port_run, name):
    want = [f for f in reference_frames[name] if f.get("event") == "token"]
    got = [f for f in port_run[name] if f.get("event") == "token"]
    assert got == want and got
    if name == "replay_after_cursor":
        assert [f["id"] for f in got][0] == "5"


@pytest.mark.parametrize("name", [s[0] for s in SCENARIO])
def test_done_payload_equals_the_reference(reference_frames, port_run, name):
    (want,) = [f for f in reference_frames[name] if f.get("event") == "done"]
    (got,) = [f for f in port_run[name] if f.get("event") == "done"]
    assert got["id"] == want["id"] and got is port_run[name][-1]
    assert _untimed(got["data"]) == _untimed(want["data"])


def test_stream_ids_run_from_zero_and_done_is_the_buffered_body(port_run):
    frames = port_run["streamed"]
    tokens = [f for f in frames if f.get("event") == "token"]
    assert [int(f["id"]) for f in tokens] == list(range(16))
    assert [f["data"]["offset"] for f in tokens] == list(range(16))
    done = frames[-1]
    assert done["event"] == "done" and done["id"] == "15"
    assert _untimed(done["data"]) == _untimed(port_run["buffered"])
    ids = [f["data"]["token"] for f in tokens]
    assert TTok(tconfigs.get_config("tiny").vocab_size).decode(ids) == port_run["buffered"]["response"]
    # a stream makes no host sync a buffered request does not
    assert port_run["syncs"][0] == port_run["syncs"][1] > 0
    m = port_run["metrics"]
    assert m["streams_started"] == 4 and m["streaming"] is True
    assert m["stream_tokens_emitted"] == sum(
        len([f for f in port_run[n] if f.get("event") == "token"])
        for n in (*(s[0] for s in SCENARIO), "streamed")
    )


# -- serve: behaviour over a duck-typed engine ---------------------------


class StubEngine:
    """Emits ``batches`` of (delay in seconds, token ids); ``cancel`` fails
    the request in flight; ``fail`` raises before any token."""

    def __init__(self, batches=((0.0, (72, 105)),), streaming=True, fail=None):
        self.batches, self.streaming, self.fail = batches, streaming, fail
        self.tokenizer = TTok(tconfigs.get_config("tiny").vocab_size)
        self.cancelled: list[str] = []
        self._cancel = None

    def has_session(self, name):
        return False

    async def chat(self, session, message, max_tokens=64, request_id="", emit=None, **kw):
        if self.fail is not None:
            raise self.fail
        self._cancel = asyncio.Event()
        ids: list[int] = []
        for delay, batch in self.batches:
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._cancel.wait(), delay)
            if self._cancel.is_set():
                raise RequestCancelled(f"request {request_id} cancelled mid-flight")
            if emit is not None:
                emit(len(ids), list(batch))
            ids += batch
        return {"text": self.tokenizer.decode(ids), "tokens": ids, "prompt_tokens": 1,
                "completion_tokens": len(ids), "ttft_ms": 1.0, "ttft_breakdown": None}

    def cancel(self, request_id):
        self.cancelled.append(request_id)
        if self._cancel is not None:
            self._cancel.set()
        return True

    def metrics(self):
        return {}

    def drain(self, budget_s):
        return True

    def shutdown(self):
        pass


def test_heartbeats_never_advance_offsets():
    stub = StubEngine(batches=((0.3, (72,)), (0.3, (105,)), (0.3, (33,))))
    with serving(stub, ATPU_STREAM_HEARTBEAT_S="0.05") as app:
        status, _, raw = post(app, "/chat", {"message": "x", "stream": True})
        beats = get_json(app, "/metrics")["stream_heartbeats"]
    frames = parse_sse(raw)
    comments = [f for f in frames if "comment" in f]
    assert status == 200 and len(comments) >= 3 and beats == len(comments)
    assert all(set(f) == {"comment"} and f["comment"] == "keep-alive" for f in comments)
    ids = [f["id"] for f in frames if "comment" not in f]
    assert ids == ["0", "1", "2", "2"]  # three tokens, then done at the last offset


def test_a_client_that_hangs_up_cancels_its_engine_request():
    stub = StubEngine(batches=((0.0, (72,)), (30.0, (105,))))
    with serving(stub) as app:
        body = json.dumps({"message": "x", "stream": True}).encode()
        sock = socket.create_connection(("127.0.0.1", app.port), timeout=10)
        sock.sendall(
            b"POST /chat HTTP/1.1\r\nHost: x\r\nX-Agentainer-Request-ID: gone-1\r\n"
            + f"Content-Length: {len(body)}\r\n\r\n".encode() + body
        )
        got = b""
        while b"event: token" not in got:
            got += sock.recv(4096)
        sock.close()
        deadline = time.monotonic() + 10
        while not stub.cancelled and time.monotonic() < deadline:
            time.sleep(0.01)
        disconnects = get_json(app, "/metrics")["stream_client_disconnects"]
    assert stub.cancelled == ["gone-1"] and disconnects == 1


def test_the_option_off_answers_buffered():
    stub = StubEngine(streaming=False)
    with serving(stub) as app:
        status, headers, raw = post(app, "/chat", {"message": "x", "stream": True})
        started = get_json(app, "/metrics")["streams_started"]
    assert status == 200 and headers["Content-Type"].startswith("application/json")
    assert json.loads(raw)["response"] == stub.tokenizer.decode([72, 105]) and started == 0


def test_a_poisoned_prefill_answers_500_before_any_frame():
    with serving(StubEngine(fail=PrefillFailed("ValueError: bad prompt"))) as app:
        status, headers, raw = post(app, "/chat", {"message": "x", "stream": True})
    assert status == 500 and headers[PREFILL_POISON_HEADER] == "true"
    assert "bad prompt" in json.loads(raw)["error"]
