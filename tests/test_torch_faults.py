"""The port's failpoint plane against ``agentainer_tpu.faults``, and the
serve layer's tiering hints (``/park``, ``/prewarm``) and new ``/metrics``
keys, on the CPU.

The same arming strings parse to the same specs, a seeded probabilistic
failpoint fires in the same sequence, budgets and delay-only failpoints
behave alike, and the catalogs agree. The serve app (tiny, f32) answers
``/park`` and ``/prewarm`` with the reference's bodies, counts them under
the reference's keys, keeps a parked session's membership, and the fleet
flags ``ATPU_FUSED_DECODE``/``ATPU_KV_TIERING`` load an engine.
"""

import asyncio
import json

import pytest

from agentainer_tpu import faults as jfaults
from agentainer_tpu_torch import faults
from agentainer_tpu_torch.engine.llm_serve import LLMServeApp, Request

SPECS = [
    "engine.prefill",
    "engine.prefill:error=RuntimeError,count=2",
    "store.get:error=ConnectionError,probability=0.3,seed=7;engine.stream:delay_ms=500,error=none",
    " engine.kv_demote : error=TimeoutError , count=-1 ; ; engine.kv_promote:seed=3",
]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm_all()
    jfaults.disarm_all()


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_reference(spec):
    assert faults.parse_spec(spec) == jfaults.parse_spec(spec)


@pytest.mark.parametrize("bad", ["engine.x:count", "engine.x:colour=red", ":count=1", "engine.x:error=KeyError"])
def test_bad_specs_are_refused_alike(bad):
    with pytest.raises(ValueError):
        jfaults.arm_spec(bad)
    with pytest.raises(ValueError):
        faults.arm_spec(bad)


def test_catalog_and_error_types_match_reference():
    assert faults.CATALOG == jfaults.CATALOG
    assert set(faults.ERROR_TYPES) == set(jfaults.ERROR_TYPES)
    assert all(faults.ERROR_TYPES[k] is jfaults.ERROR_TYPES[k] for k in ("RuntimeError", "OSError"))
    # the engine seams the port fires are in the catalog
    for name in (
        "engine.submit", "engine.snapshot", "engine.prefill", "engine.decode_step",
        "engine.fused_decode", "engine.page_alloc", "engine.kv_demote", "engine.kv_promote",
        "engine.stream",
    ):
        assert name in faults.CATALOG


def _sequence(mod, n: int) -> list[str]:
    out = []
    for _ in range(n):
        try:
            mod.fire("p")
            out.append("-")
        except Exception as e:
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("seed,probability", [(7, 0.3), (0, 0.5), (123, 0.9)])
def test_seeded_fire_sequence_matches_reference(seed, probability):
    spec = f"p:error=TimeoutError,probability={probability},seed={seed}"
    faults.arm_spec(spec)
    jfaults.arm_spec(spec)
    got, want = _sequence(faults, 200), _sequence(jfaults, 200)
    assert got == want
    assert 0 < got.count("TimeoutError") < 200
    assert faults.active() == jfaults.active()


def test_budgets_match_reference():
    for mod in (faults, jfaults):
        mod.arm("p", error="RuntimeError", count=3)
    assert _sequence(faults, 6) == _sequence(jfaults, 6) == ["RuntimeError"] * 3 + ["-"] * 3
    (fp,) = faults.active()
    assert (fp["fired"], fp["evaluated"], fp["count"]) == (3, 6, 0)
    assert faults.active() == jfaults.active()


def test_delay_only_failpoint_sleeps_and_never_raises():
    faults.arm("p", error="none", delay_ms=20, count=2)
    jfaults.arm("p", error="none", delay_ms=20, count=2)
    assert _sequence(faults, 3) == _sequence(jfaults, 3) == ["-"] * 3
    asyncio.run(faults.fire_async("p"))  # budget spent: inert
    assert faults.active()[0]["fired"] == 2


def test_async_fire_and_disarm():
    faults.arm("q", error="ValueError")
    with pytest.raises(ValueError, match="failpoint 'q' injected ValueError"):
        asyncio.run(faults.fire_async("q"))
    assert faults.armed("q") and faults.disarm("q") and not faults.armed("q")
    faults.fire("q")  # disarmed: a no-op


def test_arm_from_env(monkeypatch):
    monkeypatch.setenv("ATPU_FAULTS", "engine.prefill:count=1;engine.stream:error=none")
    assert faults.arm_from_env() == ["engine.prefill", "engine.stream"]
    with pytest.raises(faults.FaultInjected):
        faults.fire("engine.prefill")
    faults.fire("engine.prefill")  # budget spent


def test_engine_seams_fire(tmp_path):
    """The engine's submit and prefill seams fail a request typed as the
    reference's do; the decode seam fails the batch and the engine serves
    on."""
    from agentainer_tpu_torch.engine.llm import LLMEngine

    eng = LLMEngine.create(
        "tiny", options={"device": "cpu", "max_batch": 2, "max_seq": 64, "speculative": False}
    )
    try:
        faults.arm("engine.submit", error="ConnectionError", count=1)
        with pytest.raises(ConnectionError):
            asyncio.run(eng.generate("hi", max_tokens=4, request_id="r1"))
        faults.arm("engine.prefill", error="RuntimeError", count=1)
        with pytest.raises(Exception, match="failpoint 'engine.prefill'"):
            asyncio.run(eng.generate("hi", max_tokens=4, request_id="r2"))
        faults.arm("engine.decode_step", error="RuntimeError", count=1)
        with pytest.raises(RuntimeError, match="engine.decode_step"):
            asyncio.run(eng.generate("hi", max_tokens=4, request_id="r3"))
        assert asyncio.run(eng.generate("hi", max_tokens=4, request_id="r4"))["tokens"]
    finally:
        eng.shutdown()


# -- the serve layer: /park, /prewarm and the new /metrics keys ------------

ENV = {"AGENTAINER_AGENT_ID": "agent-f", "AGENTAINER_MODEL_CONFIG": "tiny"}


def _app(options: dict, **env) -> LLMServeApp:
    app = LLMServeApp(env={**ENV, "AGENTAINER_MODEL_OPTIONS": json.dumps({"device": "cpu", **options}), **env})
    app._load_engine()
    assert app.engine is not None, app.engine_error
    return app


def _post(app, handler, body: dict):
    return asyncio.run(handler(Request("POST", "/", {}, json.dumps(body).encode())))


@pytest.fixture(scope="module")
def tier_app():
    app = _app({"max_batch": 2, "max_seq": 128, "kv_tiering": True, "paged_kv": True, "page_size": 16})
    yield app
    app.engine.shutdown()


def test_park_and_prewarm_routes(tier_app):
    app = tier_app
    chat = _post(app, app.h_chat, {"message": "hello", "session": "p", "max_tokens": 4})
    assert chat.status == 200
    park = _post(app, app.h_park, {"session": "p"})
    assert park.status == 200 and park.doc["parked"] is True and park.doc["bytes"] > 0
    assert app.engine.has_session("agent-f::p") and "agent-f::p" not in app.engine.sessions
    again = _post(app, app.h_park, {"session": "p"})
    assert again.doc == {"parked": False, "reason": "unknown or busy"}
    assert _post(app, app.h_prewarm, {"session": "p"}).doc == {"prewarmed": True}
    assert "agent-f::p" in app.engine.sessions
    assert _post(app, app.h_prewarm, {"session": "nobody"}).doc == {"prewarmed": False}
    m = asyncio.run(app.h_metrics(Request("GET", "/metrics", {}, b""))).doc
    assert (m["kv_parks"], m["kv_prewarms"], m["kv_park_errors"], m["kv_prewarm_errors"]) == (1, 1, 0, 0)
    bad = asyncio.run(app.h_park(Request("POST", "/park", {}, b"{not json")))
    assert bad.status == 400


def test_a_parked_session_keeps_its_membership(tier_app):
    """A parked session's next /chat is a continuation (no persona again):
    the serve layer asks the engine across tiers."""
    app = tier_app
    app.system_prompt = "You are terse."
    try:
        _post(app, app.h_chat, {"message": "one", "session": "m", "max_tokens": 3})
        assert _post(app, app.h_park, {"session": "m"}).doc["parked"] is True
        before = app.engine.tier_promotions_total
        r = _post(app, app.h_chat, {"message": "two", "session": "m", "max_tokens": 3})
        assert r.status == 200 and app.engine.tier_promotions_total == before + 1
        assert r.doc["usage"]["prompt_tokens"] == len(app.engine.tokenizer.encode("two"))
    finally:
        app.system_prompt = ""


def test_hints_with_tiering_off_and_the_metrics_keys():
    """With tiering off the hints answer as the reference's; /metrics
    carries the reference engine's fused and tier keys and the serve
    layer's hint counters."""
    from agentainer_tpu.engine.llm import LLMEngine as JEngine

    app = _app({"max_batch": 1, "max_seq": 64})
    try:
        assert _post(app, app.h_park, {"session": "x"}).doc == {"parked": False, "reason": "tiering off"}
        assert _post(app, app.h_prewarm, {}).doc == {"prewarmed": False, "reason": "tiering off"}
        m = asyncio.run(app.h_metrics(Request("GET", "/metrics", {}, b""))).doc
    finally:
        app.engine.shutdown()
    jeng = JEngine.create("tiny", options={"max_batch": 1, "max_seq": 64, "skip_warmup": True})
    try:
        want = {
            k for k in jeng.metrics()
            if k.startswith(("fused_", "inloop_", "tier_", "kv_tiering", "host_syncs"))
        }
    finally:
        jeng.shutdown()
    assert want <= set(m)
    assert {"kv_parks", "kv_park_errors", "kv_prewarms", "kv_prewarm_errors"} <= set(m)
    assert m["fused_decode"] is False and m["kv_tiering"] is False


@pytest.mark.parametrize(
    "env,flag",
    [({"ATPU_FUSED_DECODE": "1"}, "fused_decode"), ({"ATPU_KV_TIERING": "1"}, "kv_tiering")],
)
def test_fleet_flags_load_an_engine(env, flag):
    app = _app({"max_batch": 1, "max_seq": 64}, **env)
    try:
        assert getattr(app.engine, flag) is True
        r = _post(app, app.h_chat, {"message": "hi", "max_tokens": 3})
        assert r.status == 200 and r.doc["usage"]["completion_tokens"] > 0
    finally:
        app.engine.shutdown()


def test_stream_failpoint_truncates_the_stream():
    """An armed engine.stream ends a streamed /chat without its done frame
    (the reference's per-event seam)."""

    class Sink:
        def __init__(self):
            self.frames, self.started = [], False

        async def write(self, data):
            self.started = True
            self.frames.append(data)

        def hangup(self):
            return asyncio.ensure_future(asyncio.sleep(3600))

    app = _app({"max_batch": 1, "max_seq": 64, "streaming": True})
    try:
        faults.arm("engine.stream", error="ConnectionResetError", count=1)
        req = Request("POST", "/chat", {}, json.dumps({"message": "hi", "stream": True, "max_tokens": 4}).encode())
        req.stream = Sink()

        async def go():
            return await app.h_chat(req)

        resp = asyncio.run(go())
        assert resp.streamed or resp.status == 499
        assert not any(b"event: done" in f for f in req.stream.frames)
    finally:
        app.engine.shutdown()
